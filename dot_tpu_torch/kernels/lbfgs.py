"""Plain PyTorch versions of K9, the vector passes of the L-BFGS two-loop
(dot_tpu/steppers/quasi_newton.py:116-165 _two_loop), and of its two
fused entries (csrc/lbfgs.cu: one launch each around the H0 apply):

  lbfgs_first    lbfgs_loop1, then q = -g - k^T T      -> (q, k, G)
  lbfgs_second   lbfgs_loop2, then out = r + c^T S     -> out

The two-loop needs every inner product of the recursion, and dot_tpu
derives them all from three contractions plus O(m^2) scalar recurrences
(q_i and r_i only change by combinations of the history vectors):

  lbfgs_loop1    sq = S q0 and G = S T^T with q0 = -g, then loop 1
                 (newest -> oldest): k_i = (sq_i - sum_{j>i} k_j G[i, j])
                 / rho_i
  lbfgs_combine  x + c^T V, each term with either sign (q = -g - k^T T,
                 and r + c^T S after the H0 apply)
  lbfgs_loop2    tr = T r, then loop 2 (oldest -> newest):
                 c_i = k_i - (tr_i + sum_{j<i} c_j G[j, i]) / rho_i

S, T: (m, n) histories (oldest .. newest), rho: (m,) t.s, valid: (m,) 0/1;
an invalid slot has 1/rho = 0. These are the torch code the port ran
before the kernel existed; the CPU tests use them, and
System(use_kernels=False) takes them on any device.
"""

from __future__ import annotations

import torch


def inv_rho(rho, valid):
    """1/rho where the slot holds a pair, else 0."""
    return torch.where(valid > 0, 1.0 / rho, 0.0) * valid


def lbfgs_loop1_ref(S, T, g, rho, valid):
    """(k (m,), G (m, m)) of loop 1 from the gradient g (n,)."""
    m = S.shape[0]
    q0 = -g
    sq = S @ q0                                     # (m,) s_i . q0
    G = S @ T.T                                     # (m, m) s_i . t_j
    ir = inv_rho(rho, valid)
    ks = [None] * m
    for i in reversed(range(m)):
        si_q = sq[i]
        for j in range(i + 1, m):
            si_q = si_q - ks[j] * G[i, j]
        ks[i] = si_q * ir[i]
    return torch.stack(ks), G


def lbfgs_loop2_ref(T, r, k, G, rho, valid):
    """c (m,) of loop 2 from the H0-applied r (n,), loop 1's k and G."""
    m = T.shape[0]
    tr = T @ r                                      # (m,) t_i . r
    ir = inv_rho(rho, valid)
    cs = [None] * m
    for i in range(m):
        ti_r = tr[i]
        for j in range(i):
            ti_r = ti_r + cs[j] * G[j, i]
        cs[i] = k[i] - ti_r * ir[i]
    return torch.stack(cs)


def lbfgs_combine_ref(x, c, V, neg_x=False, neg_c=False):
    """(+-x) + (+-(c^T V)) for x (n,), c (m,), V (m, n)."""
    cv = c @ V
    x = -x if neg_x else x
    return x - cv if neg_c else x + cv


def lbfgs_first_ref(S, T, g, rho, valid):
    """K9's first entry: (q (n,), k (m,), G (m, m)) from the gradient g."""
    k, G = lbfgs_loop1_ref(S, T, g, rho, valid)
    return lbfgs_combine_ref(g, k, T, neg_x=True, neg_c=True), k, G


def lbfgs_second_ref(T, S, r, k, G, rho, valid):
    """K9's second entry: r + c^T S (n,) from the H0-applied r, with c
    from loop 2."""
    return lbfgs_combine_ref(r, lbfgs_loop2_ref(T, r, k, G, rho, valid), S)

"""Conformance cases for the paged-decode kernel.

The same inputs check the plain version against the JAX oracle on the
CPU (``tests/test_torch_paged_decode.py``) and the CUDA kernel against
the plain version on the card (``chip_smoke.py``): random pools and
well-formed compacted lists (distinct pool rows, ascending positions)
with each slot's queries at its write frontier, all drawn from a numpy
``RandomState``.
"""
from __future__ import annotations

import numpy as np
import torch


def rand_case(seed, B, K1, Hq, Hkv, dh, P_loc, psz, ppc, n_live=None,
              partial_last=False):
    """Numpy arrays ``(q, k_pool, v_pool, cl_page, cl_pos, qpos)``."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, K1, Hq, dh)).astype(np.float32)
    k_pool = rng.standard_normal((P_loc, psz, Hkv, dh)).astype(np.float32)
    v_pool = rng.standard_normal((P_loc, psz, Hkv, dh)).astype(np.float32)
    clp = np.full((B, ppc), -1, np.int32)
    clo = np.full((B, ppc), -1, np.int32)
    qpos = np.zeros((B, K1), np.int32)
    for b in range(B):
        n = rng.randint(1, ppc + 1) if n_live is None else n_live
        if n:
            clp[b, :n] = rng.choice(P_loc, n, replace=False)
            clo[b, :n] = np.sort(rng.choice(ppc * 4, n, replace=False)) * psz
            last = int(clo[b, n - 1])
            off = rng.randint(0, psz) if partial_last else psz - 1
            qpos[b] = last + max(off, K1 - 1) - np.arange(K1)[::-1]
    return q, k_pool, v_pool, clp, clo, qpos


#: name -> (rand_case kwargs, window, cap, slot rows emptied to all -1)
CASES = {
    "gqa": (dict(seed=0, B=5, K1=1, Hq=4, Hkv=2, dh=16, P_loc=12, psz=8,
                 ppc=4), 0, 0.0, ()),
    "window_softcap": (dict(seed=1, B=4, K1=2, Hq=4, Hkv=4, dh=16,
                            P_loc=10, psz=8, ppc=4), 16, 8.0, ()),
    "k1_3": (dict(seed=2, B=5, K1=3, Hq=8, Hkv=2, dh=16, P_loc=12, psz=8,
                  ppc=4), 0, 0.0, ()),
    "partial_last_page": (dict(seed=3, B=6, K1=1, Hq=4, Hkv=4, dh=16,
                               P_loc=9, psz=8, ppc=3, partial_last=True),
                          0, 0.0, ()),
    "pool_much_larger": (dict(seed=4, B=3, K1=2, Hq=4, Hkv=4, dh=16,
                              P_loc=128, psz=8, ppc=2, n_live=1),
                         0, 0.0, ()),
    "evicted_row": (dict(seed=5, B=3, K1=2, Hq=4, Hkv=4, dh=16, P_loc=8,
                         psz=8, ppc=3), 0, 0.0, (1,)),
}


def case_arrays(name):
    """``(arrays, window, cap)`` of a named case, evicted rows applied."""
    kw, window, cap, dead = CASES[name]
    q, kp, vp, clp, clo, qpos = rand_case(**kw)
    for b in dead:
        clp[b] = -1
        clo[b] = -1
    return (q, kp, vp, clp, clo, qpos), window, cap


def to_tensors(arrays, device, pool_dtype=torch.float32):
    """Explicit device copies; pools cast to ``pool_dtype``."""
    q, kp, vp, clp, clo, qpos = arrays
    t = lambda a, dt=None: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    return (t(q), t(kp, pool_dtype), t(vp, pool_dtype), t(clp), t(clo),
            t(qpos))

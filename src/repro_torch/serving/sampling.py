"""Next-token sampling from the decode logits, on the device.

The port of ``repro.serving.sampling`` at tp = 1.  Every row is sampled
on its own (no reduction mixes rows), so greedy rows are bit-identical
whatever shares the batch, and a stochastic row's noise is independent
of the other rows'.

Per-row ``temps`` selects the method:
  temps[i] == 0 : greedy, the argmax of the raw logits (lowest id on
                  ties, as ``jnp.argmax``)
  temps[i] >  0 : temperature sampling by the Gumbel-max trick on
                  ``logits / temp``, after the optional top-k (a
                  threshold at the k-th value, as ``lax.top_k``) and
                  top-p filters.  Top-p bisects the probability
                  threshold in 24 halvings, as the reference does, so
                  the kept sets are the reference's (no sort).

The noise is drawn from an explicit ``torch.Generator`` of the logits'
device.  Torch's random numbers are not JAX's: the stochastic rows
follow the reference's distribution, not its draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .staging import to_device

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Static sampling controls; ``top_k``/``top_p`` of 0 disable the
    respective filter.  Per-row temperature is an input (0 = greedy)."""

    top_k: int = 0
    top_p: float = 0.0


def dist_argmax(vals):
    """Argmax over the (unsharded) last axis -> int32 ids."""
    return torch.argmax(vals, dim=-1).to(torch.int32)


def _apply_top_k(lt, k):
    """Mask every value below each row's k-th largest to -inf."""
    thr = torch.topk(lt, min(k, lt.shape[-1]), dim=-1).values[:, -1:]
    return torch.where(lt < thr, -torch.inf, lt)


def _apply_top_p(lt, p):
    """Keep each row's nucleus: the values whose probability is at least
    the largest threshold (bisected in 24 halvings) whose kept set still
    holds ``p`` of the probability mass."""
    m = torch.amax(lt, dim=-1, keepdim=True)
    e = torch.exp(lt - m)
    probs = e / torch.sum(e, dim=-1, keepdim=True)
    lo, hi = torch.zeros_like(m), torch.ones_like(m)
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        kept = torch.sum(torch.where(probs >= mid, probs, 0.0), dim=-1,
                         keepdim=True)
        ge = kept >= p                          # still a valid nucleus
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return torch.where(probs >= lo, lt, -torch.inf)


def gumbel(shape, generator, device):
    """Standard Gumbel noise: ``-log(-log(u))`` with ``u`` uniform,
    clamped into ``[tiny, 1)`` as ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, dtype=F32, device=device)
    u = torch.clamp(u, min=torch.finfo(F32).tiny)
    return -torch.log(-torch.log(u))


def sample(logits, temps, generator=None, cfg: SamplingConfig | None = None):
    """Next tokens [B] int32 from logits [B, V].

    ``temps`` [B] host floats, 0 = greedy.  ``generator`` (a
    ``torch.Generator`` of the logits' device) draws the noise of the
    stochastic rows, one [B, V] draw for all rows when any row is
    stochastic; a batch of greedy rows draws nothing and needs none.
    """
    cfg = cfg or SamplingConfig()
    temps = np.asarray(temps, np.float32).reshape(-1)
    logits = logits.to(F32)
    greedy = dist_argmax(logits)
    if not (temps > 0).any():
        return greedy
    if generator is None:
        raise ValueError("sample: stochastic rows need a generator")
    t = to_device(temps, logits.device)
    lt = logits / torch.clamp(t, min=1e-6)[:, None]
    if cfg.top_k > 0:
        lt = _apply_top_k(lt, cfg.top_k)
    if 0.0 < cfg.top_p < 1.0:
        lt = _apply_top_p(lt, cfg.top_p)
    stoch = dist_argmax(lt + gumbel(lt.shape, generator, lt.device))
    return torch.where(t > 0, stoch, greedy)


def sample_verify(logits, temps, generator=None,
                  cfg: SamplingConfig | None = None):
    """Tokens [B, K1] from verify logits [B, K1, V]: the K1 positions are
    flattened into rows (temperatures repeated K1 times), so every
    position is sampled exactly as a decode step samples its row —
    greedy column j is the argmax a vanilla step would take after
    committing ``tokens[:, :j+1]``, and stochastic positions draw
    independent noise."""
    B, K1, V = logits.shape
    tok = sample(logits.reshape(B * K1, V),
                 np.repeat(np.asarray(temps, np.float32), K1), generator,
                 cfg)
    return tok.reshape(B, K1)

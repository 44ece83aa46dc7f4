"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train_cli \
        --arch qwen1.5-0.5b --steps 300 --batch 8 --seq 128 \
        --hnn-mode hnn --codec spike_fused --ckpt-dir build/ckpt

The port of ``repro.launch.train_cli`` at world size 1, with its flags
and one more, ``--device`` (``cuda`` by default; ``cpu`` runs the plain
versions of the kernels); ``--arch`` defaults to ``qwen1.5-0.5b``, the
reference's default (``rwkv-paper``) not being ported.  It wires
together: config -> the port's
seeded init (``--seed``; torch's generator, not the reference's bits)
-> the AdamW train step (``launch.train``) -> the deterministic data
pipeline (``SyntheticLM``) -> the fault-tolerant ``TrainLoop``
(checkpoint/restart in the reference's format, straggler watch, NaN
guard, preemption).  ``--lam`` and ``--target-rate`` replace the
codec's eq-10 penalty weight and target firing rate.  ``--mesh`` other
than ``1x1``, and ``--draft-heads`` above 0 with its options
``--draft-hidden`` and ``--init-from`` (learned draft heads), raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1", help="DPxTP; only 1x1")
    ap.add_argument("--hnn-mode", default="hnn",
                    choices=["ann", "hnn", "snn"])
    ap.add_argument("--codec", default="spike_fused")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (smoke) config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--lam", type=float, default=None,
                    help="eq-10 sparsity penalty weight (default: the "
                         "codec's, 1e-3)")
    ap.add_argument("--target-rate", type=float, default=None,
                    help="firing rate above which the penalty acts "
                         "(default: the codec's, 0.10)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--draft-heads", type=int, default=0,
                    help="train K frozen-trunk speculative draft heads "
                         "(not ported)")
    ap.add_argument("--draft-hidden", type=int, default=0,
                    help="draft heads' hidden width (not ported)")
    ap.add_argument("--init-from", default=None,
                    help="trunk checkpoint for draft-head training "
                         "(not ported)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(f"--mesh {args.mesh}: the port trains at "
                                  "world size 1 only")
    if args.draft_heads > 0 or args.draft_hidden or args.init_from:
        raise NotImplementedError("--draft-heads, --draft-hidden, "
                                  "--init-from: learned draft heads are "
                                  "not ported")

    from ..configs import get_config
    from ..configs.base import ShapeCell
    from ..configs.reduced import reduced as reduce_cfg
    from ..data.pipeline import DataConfig, SyntheticLM
    from ..optim import adamw
    from ..runtime.ft import FTConfig, TrainLoop
    from . import train as TR

    cfg = get_config(args.arch, hnn_mode=args.hnn_mode, codec=args.codec)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    cell = ShapeCell("cli", args.seq, args.batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                total_steps=max(args.steps, 1))
    params = TR.init_train_params(cfg, args.seed, device=args.device)
    step = TR.make_train_step(
        cfg, microbatches=TR.pick_microbatches(cfg, cell), opt_cfg=opt_cfg,
        device=args.device, sparsity={
            k: v for k, v in (("lam", args.lam),
                              ("target_rate", args.target_rate))
            if v is not None})
    opt = adamw.init_opt_state(params)
    n_params = sum(p.numel() for p in adamw.tree_leaves(params))
    print(f"[train] {cfg.name} mode={cfg.hnn_mode} codec={cfg.codec} "
          f"params={n_params/1e6:.2f}M device={args.device} train=lm")

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    hist = []

    def logged_step(p, o, batch):
        p, o, m = step(p, o, batch)
        hist.append(m)
        if len(hist) % args.log_every == 0:
            print(f"  step {len(hist):5d} loss={float(m['loss']):.4f} "
                  f"occ={float(m['occupancy']):.3f} "
                  f"pen={float(m['penalty']):.5f}")
        return p, o, m

    loop = TrainLoop(logged_step, data,
                     FTConfig(ckpt_dir=args.ckpt_dir,
                              ckpt_every=args.ckpt_every))
    t0 = time.time()
    params, opt, metrics = loop.run(params, opt, args.steps,
                                    resume=not args.no_resume)
    dt = time.time() - t0
    out = {
        "arch": cfg.name, "mode": cfg.hnn_mode,
        "final_loss": metrics[-1]["loss"] if metrics else None,
        "final_occupancy": (metrics[-1].get("occupancy")
                            if metrics else None),
        "steps": len(metrics), "wall_s": round(dt, 1),
        "straggler_events": loop.straggler_events,
        "nan_skips": loop.nan_skips,
    }
    print("[train] done:", json.dumps(out))
    return out, metrics


if __name__ == "__main__":
    main()

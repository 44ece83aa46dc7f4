"""Full-width ``rwkv-paper`` training on the CPU, through the reference
(``repro.launch.train``, JAX) or the port (``repro_torch.launch.train``,
plain PyTorch): the smoke's setting (f32, ``SyntheticLM`` vocab 256, 8 x
256 tokens, two microbatches, AdamW with warmup 5, the config's
penalty).  Prints each step's loss and the drop the smoke measures (step
0 against the mean of the last five).  A diagnostic, not a test: it
shows whether a codec's training learns in the reference itself.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_ref_rwkv_train.py \\
        jax spike 1e-3 30
"""
import sys

import numpy as np


def jax_losses(codec, lr, steps):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.configs.base import ShapeCell
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch import specs as SP
    from repro.launch import train as TR
    from repro.launch.mesh import make_mesh
    from repro.optim import adamw
    hnn = "ann" if codec == "none" else "hnn"
    cfg = get_config("rwkv-paper", hnn_mode=hnn, codec=codec).replace(
        dtype=jnp.float32)
    mesh = make_mesh((1, 1), ("data", "model"))
    plan = SP.make_plan(cfg, ShapeCell("t", 256, 8, "train"), mesh)
    params = TR.init_sharded_params(cfg, plan, mesh, jax.random.PRNGKey(0))
    step, *_ = TR.make_train_step(
        cfg, plan, mesh, with_optimizer=True, microbatches=2,
        opt_cfg=adamw.AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps))
    opt = adamw.init_opt_state(params)
    data = SyntheticLM(DataConfig(vocab=256, seq_len=256, global_batch=8))
    for i in range(steps):
        params, opt, m = step(params, opt, {
            k: jnp.asarray(v) for k, v in data.batch(i).items()})
        yield float(m["loss"])


def port_losses(codec, lr, steps):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as TT
    from repro_torch.optim import adamw
    hnn = "ann" if codec == "none" else "hnn"
    cfg = get_config("rwkv-paper", hnn_mode=hnn, codec=codec).replace(
        dtype=torch.float32)
    params = TT.init_train_params(cfg, 0, device="cpu")
    step = TT.make_train_step(
        cfg, microbatches=2, device="cpu",
        opt_cfg=adamw.AdamWConfig(lr=lr, warmup_steps=5, total_steps=steps))
    opt = adamw.init_opt_state(params)
    data = SyntheticLM(DataConfig(vocab=256, seq_len=256, global_batch=8))
    for i in range(steps):
        params, opt, m = step(params, opt, data.batch(i))
        yield float(m["loss"])


def main(argv):
    side, codec, lr, steps = argv[0], argv[1], float(argv[2]), int(argv[3])
    run = jax_losses if side == "jax" else port_losses
    losses = []
    for i, loss in enumerate(run(codec, lr, steps)):
        losses.append(loss)
        print(f"{side} {codec} lr {lr} step {i}: loss {loss:.4f}",
              flush=True)
    print(f"{side} {codec} lr {lr}: drop "
          f"{losses[0] - float(np.mean(losses[-5:])):.4f} nat")


if __name__ == "__main__":
    main(sys.argv[1:])

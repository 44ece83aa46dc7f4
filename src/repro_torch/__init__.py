"""PyTorch/CUDA port of ``repro`` for one NVIDIA Hopper card.

The JAX package ``repro`` stays the reference; this package grows beside
it slice by slice and imports neither JAX nor any module of ``repro``.
The first slice is greedy serving of attention-family models over a
paged KV pool (``repro_torch.serving.ServingEngine``), whose decode
attention runs through a hand-written CUDA kernel
(``repro_torch.kernels``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where every kernel takes its plain
PyTorch version.
"""

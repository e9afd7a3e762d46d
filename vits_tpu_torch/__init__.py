"""vits_tpu_torch — the PyTorch/CUDA port of vits_tpu for NVIDIA Hopper.

The JAX package `vits_tpu` is the reference; this package imports nothing of
it (nor JAX) and keeps its own copies of what it needs. Module names mirror
`vits_tpu` so each counterpart is easy to find. Public functions keep the
JAX layout, channel-last `(B, T, C)`; weights come from a JAX parameter tree
through `vits_tpu_torch.convert.params_from_jax`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU and no explicit CPU request they raise (`vits_tpu_torch.device`).
"""

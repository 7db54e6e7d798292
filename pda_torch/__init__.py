"""pda_torch — the PyTorch/CUDA port of ``pda`` for one NVIDIA H100.

The JAX package ``pda`` is the reference: every module here mirrors the
``pda`` module of the same name and is held against it by the tests
(``tests/test_torch_*.py``), with the same weights, inputs and noise.
Public functions keep ``pda``'s channel-last layout: tiles and batches are
``(N, H, W, C)``, images ``(H, W, C)``.

Layer map of the ported slices (serving, and the supervised and
Mean-Teacher train steps):
  pda_torch.core     DiagGaussian, consensus, losses/ELBO, EMA, L2, dice
  pda_torch.models   PUNet modules (reference torch state-dict names)
  pda_torch.kernels  hand-written CUDA kernels for sm_90a + plain versions
  pda_torch.infer    tiled MC prediction, pseudo-label/consensus export
  pda_torch.train    train state, Adam, supervised and Mean-Teacher steps

This package imports torch and numpy only — never jax, flax or pda.
"""

__version__ = "0.1.0"

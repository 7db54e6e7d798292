"""pda_torch — the PyTorch/CUDA port of ``pda`` for one NVIDIA H100.

The JAX package ``pda`` is the reference: every module here mirrors the
``pda`` module of the same name and is held against it by the tests
(``tests/test_torch_*.py``), with the same weights, inputs and noise.
Public functions keep ``pda``'s channel-last layout: tiles and batches are
``(N, H, W, C)``, images ``(H, W, C)``.

Layer map of the ported slices (serving, every training algorithm's step
and its trainer, the UNet2d path):
  pda_torch.data     numpy transforms, 2D patch datasets, the Loader, synthetic data
  pda_torch.core     DiagGaussian, consensus, alignment, losses/ELBO, EMA, L2, dice
  pda_torch.models   PUNet and UNet2d modules (reference torch state-dict names)
  pda_torch.kernels  hand-written CUDA kernels for sm_90a + plain versions
  pda_torch.infer    tiled MC prediction, pseudo-label/consensus export, UNet
  pda_torch.train    the eight trainers (fit, validation, .pt checkpoints, plateau,
                     TensorBoard panels), train state, Adam, the steps
  pda_torch.eval     dice evaluation runners

This package imports torch and numpy only — never jax, flax or pda.
"""

__version__ = "0.1.0"

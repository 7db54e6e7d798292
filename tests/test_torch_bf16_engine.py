"""``Trainer(mixed_precision=True)`` on the CPU, as ``pda``'s engine takes
it: a model with a compute ``dtype`` (the PUNet, its teacher too) computes
in bf16 while its parameters, their gradients, the optimizer and the
checkpoints stay float32; a model without one (``UNet2d``) stays float32."""

import os

import torch

from pda_torch import train as ttrain
from pda_torch.models import UNet2d
from pda_torch.train import ReduceLROnPlateau, load_checkpoint
from pda_torch.train.checkpoint import LATEST
from test_torch_checkpoint import _loaders, _punet


def _mt(root, name="mt"):
    return ttrain.MeanTeacherTrainer(name, _punet(), *_loaders(True), save_root=str(root),
                                     device="cpu", logger=False, do_consensus_masking=True,
                                     lr_scheduler=ReduceLROnPlateau(patience=0),
                                     mixed_precision=True)


def test_mixed_precision_trains_the_punet_in_bf16(tmp_path):
    trainer = _mt(tmp_path)
    seen = []
    block = trainer.model.unet.contracting_path[1]

    def record(mod, args, out):
        # a block whose output feeds the next level's pool gives (output, pooled map)
        for o in out if isinstance(out, tuple) else (out,):
            seen.append((args[0].dtype, o.dtype))

    block.register_forward_hook(record)
    trainer.fit(2)
    assert trainer.model.dtype == torch.bfloat16
    assert trainer.state.teacher.dtype == torch.bfloat16
    # the block takes the pooled bf16 map of the block before and gives bf16
    assert seen and set(seen) == {(torch.bfloat16, torch.bfloat16)}
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert all(torch.isfinite(torch.tensor(h["loss"])) for _, h in trainer.history)
    blob = load_checkpoint(trainer.ckpt_dir, which=LATEST)
    for key in ("model_state", "teacher_state"):
        assert {v.dtype for v in blob[key].values()} == {torch.float32}, key
    # a fresh mixed-precision trainer reloads the float32 checkpoint bit for bit
    fresh = _mt(tmp_path)
    fresh.load_checkpoint(LATEST)
    for v, w in zip(trainer.model.state_dict().values(), fresh.model.state_dict().values()):
        assert torch.equal(v, w)
    assert fresh.model.dtype == torch.bfloat16


def test_mixed_precision_leaves_a_model_without_dtype_in_float32(tmp_path):
    model = UNet2d(depth=2, initial_features=4, generator=torch.Generator().manual_seed(1))
    trainer = ttrain.UNetTrainer("unet", model, *_loaders(False), save_root=str(tmp_path),
                                 device="cpu", logger=False, mixed_precision=True)
    trainer.fit(1)
    assert not hasattr(trainer.model, "dtype")
    out = trainer.model(torch.zeros(1, 32, 32, 1))
    assert out.dtype == torch.float32
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    assert os.path.exists(os.path.join(trainer.ckpt_dir, "latest.pt"))

"""Checkpoints through ``torch.distributed.checkpoint`` (DCP): the port's
counterpart of ``pda/train/orbax_io.py`` (``save_orbax``, ``load_orbax``).

The engine's checkpoint stays the single ``.pt`` file (:mod:`.checkpoint`).
For a checkpoint that a world of ranks writes together, and that a world of
any size or one process reads back, :func:`save_dcp` writes the entries of
:func:`.checkpoint.save_checkpoint` as a DCP directory, and :func:`load_dcp`
restores them in place into a template state, as orbax's ``restore`` takes
an abstract template. Nothing in the port calls them.

The DCP keys:

  ``model.<name>``, ``teacher.<name>``   the modules' state dicts
  ``optimizer.<parameter>.<key>``      the optimizer's per-parameter state
                                       (Adam's ``step``, ``exp_avg``,
                                       ``exp_avg_sq``), keyed by the
                                       parameter's name in the student where
                                       ``Optimizer.state_dict()`` keys it by
                                       index: DCP matches entries by name
  ``extra.<key>``                      each tensor of ``extra`` (the noise
                                       generators' states)
  ``meta``                             the iteration, the optimizer's
                                       ``param_groups`` (their parameters
                                       named) and every other entry of
                                       ``extra`` (the plateau controller's
                                       state), one ``torch.save`` blob

Both functions work with and without a process group. Where
``torch.distributed`` is initialized every rank calls them: DCP writes each
tensor that every rank holds once (``__<rank>_0.distcp`` files share the
items), and every rank reads all of it back.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import warnings
from typing import Optional

import torch
import torch.distributed as dist

META = "meta"


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


@contextlib.contextmanager
def _quiet():
    """Without DCP's warning that it runs in one process, which ``no_dist``
    asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _param_names(state) -> list:
    """The student's name of each parameter the optimizer holds, in the
    optimizer's index order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = []
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            if id(p) not in names:
                raise ValueError("the optimizer holds a parameter the student does not")
            out.append(names[id(p)])
    return out


def _entries(state, extra: dict) -> dict:
    names = _param_names(state)
    opt = state.optimizer.state_dict()
    flat = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    if state.teacher is not None:
        flat.update({f"teacher.{k}": v for k, v in state.teacher.state_dict().items()})
    opt_values = {}
    for idx, entries in opt["state"].items():
        for key, value in entries.items():
            if torch.is_tensor(value):
                flat[f"optimizer.{names[idx]}.{key}"] = value
            else:
                opt_values.setdefault(names[idx], {})[key] = value
    flat.update({f"extra.{k}": v for k, v in extra.items() if torch.is_tensor(v)})
    meta = {"iteration": int(state.step),
            "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                             for g in opt["param_groups"]],
            "optimizer_values": opt_values,
            "extra": {k: v for k, v in extra.items() if not torch.is_tensor(v)}}
    blob = io.BytesIO()
    torch.save(meta, blob)
    flat[META] = blob.getvalue()
    return flat


def save_dcp(directory: str, state, *, extra: Optional[dict] = None) -> str:
    """Write ``state`` (a :class:`.state.TrainState`) and ``extra`` as a DCP
    checkpoint at ``directory``, replacing whatever is there (orbax's
    ``force=True``): the ranks write into ``<directory>.tmp``, which then
    takes the place of the old directory, so an older checkpoint, such as
    one from a larger world, leaves no file behind. Returns the absolute
    path."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(directory)
    tmp = path + ".tmp"
    group = _in_group()
    lead = not group or dist.get_rank() == 0
    if lead:
        shutil.rmtree(tmp, ignore_errors=True)
    if group:
        dist.barrier()
    with _quiet():
        dcp.save(_entries(state, extra or {}), checkpoint_id=tmp, no_dist=not group)
    if lead:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.unlink(path)
        os.replace(tmp, path)
    if group:
        dist.barrier()
    return path


def load_dcp(directory: str, state, *, extra: Optional[dict] = None):
    """Restore a checkpoint of :func:`save_dcp` into ``state``, in place:
    the student's and the teacher's tensors (their names must be the
    checkpoint's), the optimizer's state (as ``Optimizer.load_state_dict``
    of the ``.pt`` path's) and the iteration. ``extra``, a dict, receives the
    checkpoint's ``extra`` entries. Returns ``state``."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(directory)
    stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    template = {}
    for prefix, module in (("model", state.model), ("teacher", state.teacher)):
        if module is None:
            continue
        own = {f"{prefix}.{k}": v for k, v in module.state_dict().items()}
        theirs = {k for k in stored if k.startswith(prefix + ".")}
        if set(own) != theirs:
            raise KeyError(f"load_dcp: {path} holds another {prefix}: missing "
                           f"{sorted(set(own) - theirs)[:5]}, unexpected "
                           f"{sorted(theirs - set(own))[:5]}")
        template.update(own)
    # the optimizer's and extra's tensors are read to the host at their stored
    # shapes, as the .pt path reads its file with map_location="cpu"
    for k, md in stored.items():
        if k.startswith(("optimizer.", "extra.")):
            template[k] = torch.empty(md.size, dtype=md.properties.dtype)
    template[META] = b""
    with _quiet():
        dcp.load(template, checkpoint_id=path, no_dist=not _in_group())
    meta = torch.load(io.BytesIO(template[META]), weights_only=True)

    index = {n: i for i, n in enumerate(_param_names(state))}
    opt_state = {}
    for k, v in template.items():
        if k.startswith("optimizer."):
            name, key = k[len("optimizer."):].rsplit(".", 1)
            opt_state.setdefault(index[name], {})[key] = v
    for name, values in meta["optimizer_values"].items():
        opt_state.setdefault(index[name], {}).update(values)
    groups = [{**g, "params": [index[n] for n in g["params"]]} for g in meta["param_groups"]]
    state.optimizer.load_state_dict({"state": opt_state, "param_groups": groups})
    state.step = int(meta["iteration"])
    if extra is not None:
        extra.update(meta["extra"])
        extra.update({k[len("extra."):]: v for k, v in template.items()
                      if k.startswith("extra.")})
    return state

"""What the development tools share: the device a tool runs on (the card
unless ``--device cpu``; a card run without a card raises, it never falls
back; on the card TF32 is off for cuDNN and matmul, as in ``chip_smoke.py``)
and the card's name and power limit, as ``nvidia-smi`` gives them."""

from __future__ import annotations

import argparse
import subprocess

import torch


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the card) or cpu (the plain versions)")


def tool_device(name: str, tool: str) -> torch.device:
    """``torch.device(name)``; raises where a CUDA device is asked for and
    there is no card."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tool}: no CUDA card (torch.cuda.is_available() is False); pass "
                           "--device cpu to run on the CPU")
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def card(dev: torch.device) -> str:
    """``name, power limit`` of the card (``nvidia-smi``), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "-i", str(dev.index or 0),
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()

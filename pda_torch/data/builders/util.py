"""Download and unzip plumbing for the dataset builders (port of
``pda/data/builders/util.py``; torch_em's ``download_source`` and
``unzip``). A file already in place is never fetched; a missing one with
``download=False`` raises, naming where to put it. Downloads are
checksum-verified when a checksum is given.
"""

from __future__ import annotations

import hashlib
import os
import zipfile


def download_source(path: str, url: str, download: bool, checksum: str | None = None):
    if os.path.exists(path):
        return path
    if not download:
        raise RuntimeError(
            f"Dataset file {path} is missing and download=False. "
            f"Place the file there manually (source: {url})."
        )
    import urllib.request

    try:
        print(f"Downloading {url} -> {path}")
        urllib.request.urlretrieve(url, path)
    except Exception as e:  # zero-egress environments land here
        raise RuntimeError(
            f"Could not download {url} ({e}). If this machine has no network "
            f"access, download the file elsewhere and place it at {path}."
        ) from e

    if checksum is not None:
        sha = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                sha.update(chunk)
        digest = sha.hexdigest()
        if digest != checksum:
            raise RuntimeError(
                f"Checksum mismatch for {path}: expected {checksum}, got {digest}"
            )
    return path


def unzip(zip_path: str, dst: str, remove: bool = True):
    with zipfile.ZipFile(zip_path, "r") as f:
        f.extractall(dst)
    if remove:
        os.remove(zip_path)

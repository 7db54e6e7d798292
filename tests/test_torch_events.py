"""The port's TensorBoard event writer (pda_torch/train/events.py) on the CPU:
CRC-32C against its check value and tensorboardX's; the port's logger files
read back with tensorboard's own event reader, against the files
tensorboardX writes for ``pda``'s logger on the same ``log_train`` and
``log_validation`` calls (tags, steps, values, decoded images); the port's
own reader (records' lengths and CRCs, the fields) against tensorboard's;
and a port trainer's ``fit`` in a subprocess with tensorboardX blocked, its
writes replayed through tensorboardX here."""

import glob
import io
import os
import pickle
import socket
import struct
import subprocess
import sys
import types

import numpy as np
import pytest
from PIL import Image

# tensorboard's reader (the events as written, not migrated to tensors) on its own
# protobuf stub, not TensorFlow's (slow to import)
sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
from tensorboard.backend.event_processing.event_file_loader import (  # noqa: E402
    LegacyEventFileLoader as EventFileLoader)
from tensorboardX import SummaryWriter  # noqa: E402
from tensorboardX.crc32c import crc32c as tbx_crc32c  # noqa: E402

from pda_torch.train import events  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_crc32c_check_value():
    assert events.crc32c(b"123456789") == 0xE3069283
    assert events.crc32c(b"") == 0


@pytest.mark.parametrize("n", [1, 7, 8, 255, 4096, 16 * 4096 - 1, 16 * 4096, 16 * 4096 + 1,
                               37 * 4096 + 123, 64 * 4096, 10**6])
def test_crc32c_matches_tensorboardx(n):
    """Byte by byte below 64 KiB, in 4 KiB lanes from there (odd and even
    lane counts, a tail of bytes)."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert events.crc32c(data) == tbx_crc32c(data)


def read(log_dir):
    """Every event of the one event file in ``log_dir``, by tensorboard's reader:
    (step, tag, kind, value) with images decoded, and the first event."""
    files = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    assert len(files) == 1, files
    evs = list(EventFileLoader(files[0]).Load())
    out = []
    for ev in evs[1:]:
        for v in ev.summary.value:
            if v.HasField("image"):
                img = np.asarray(Image.open(io.BytesIO(v.image.encoded_image_string)))
                out.append((ev.step, v.tag, "image",
                            (v.image.height, v.image.width, v.image.colorspace, img)))
            else:
                out.append((ev.step, v.tag, "scalar", v.simple_value))
    return files[0], evs[0], out


def assert_same_events(got, want):
    assert [e[:3] for e in got] == [e[:3] for e in want]
    for a, b in zip(got, want):
        if a[2] == "scalar":
            assert a[3] == b[3], a[:2]
        else:
            assert a[3][:3] == b[3][:3], a[:2]
            assert a[3][3].dtype == b[3][3].dtype and np.array_equal(a[3][3], b[3][3]), a[:2]


def calls(rng):
    """log_train / log_validation calls of a Mean Teacher logger: raw views
    (normalized for display), pseudo-labels and maps in [0, 1], a batch."""
    img = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    unit = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    out = []
    for step in range(4):
        out.append(("log_train", step, {"loss": float(rng.random()), "learning_rate": 1e-5}, None))
        if step % 2 == 0:
            out.append(("log_train", step, {}, {
                "input": img(24, 20, 1), "aug_inputs_1": img(2, 24, 20, 1),
                "aug_inputs_2": img(24, 20), "teacher_predictions": unit(24, 20, 1),
                "teacher_consensus": (unit(24, 20) > 0.5).astype(np.float32),
                "ground_truth": unit(24, 20, 1), "model_samples": unit(24, 20, 3)}))
    out.append(("log_validation", 4, {"loss": 0.25, "metric": 0.5, "gt_metric": 0.75},
                {"input": img(24, 20, 1), "model_samples": unit(1, 24, 20, 1)}))
    return out


def test_logger_files_match_tensorboardx(tmp_path):
    from pda.train.logging import MeanTeacherLogger as JLogger

    from pda_torch.train.logging import MeanTeacherLogger as TLogger

    loggers = {"port": TLogger("mt", str(tmp_path / "port"), log_image_interval=2),
               "pda": JLogger("mt", str(tmp_path / "pda"), log_image_interval=2)}
    for side, logger in loggers.items():
        for method, step, scalars, images in calls(np.random.default_rng(0)):
            getattr(logger, method)(step, scalars, images)
        logger.close()
    path, first, got = read(loggers["port"].log_dir)
    _, first_tbx, want = read(loggers["pda"].log_dir)
    assert first.file_version == first_tbx.file_version == "brain.Event:2"
    name = os.path.basename(path).split(".")
    assert name[:3] == ["events", "out", "tfevents"] and len(name[3]) == 10
    assert ".".join(name[4:]) == socket.gethostname()
    assert sum(kind == "image" for _, _, kind, _ in got) == 16
    assert_same_events(got, want)


def test_own_reader_matches_tensorboards(tmp_path):
    w = events.EventWriter(str(tmp_path))
    w.add_scalar("train/loss", 0.125, 3)
    w.add_scalar("odd tag:x", -2.5, 2**40)
    w.add_image("validation/input", np.random.default_rng(1).random((1, 9, 7)), 0)
    w.close()
    records = events.read_records(w.path)
    parsed = [events.parse_event(r) for r in records]
    loaded = list(EventFileLoader(w.path).Load())
    assert len(parsed) == len(loaded) == 4
    assert parsed[0]["file_version"] == "brain.Event:2"
    for p, ev in zip(parsed, loaded):
        assert p["wall_time"] == ev.wall_time and p["step"] == ev.step
        for pv, v in zip(p["values"], ev.summary.value):
            assert pv["tag"] == v.tag
            if "image" in pv:
                assert pv["image"]["png"] == v.image.encoded_image_string
                assert (pv["image"]["height"], pv["image"]["width"],
                        pv["image"]["colorspace"]) == (9, 7, 3)
            else:
                assert pv["simple_value"] == v.simple_value
    assert parsed[2]["values"][0]["tag"] == "odd_tag_x"  # tensorboardX's cleaning
    # a flipped bit fails its record's CRC
    data = bytearray(open(w.path, "rb").read())
    data[len(data) // 2] ^= 1
    bad = tmp_path / "bad"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        events.read_records(str(bad))


def test_framing(tmp_path):
    rec = events.tfrecord(b"abc")
    (n,) = struct.unpack("<Q", rec[:8])
    assert n == 3 and rec[12:15] == b"abc" and len(rec) == 19
    crc = tbx_crc32c(rec[:8])
    assert struct.unpack("<I", rec[8:12])[0] == (((crc >> 15) | (crc << 17)) + 0xA282EAD8) % 2**32


FIT = r"""
import pickle, sys
sys.modules["tensorboardX"] = None
import torch
from pda_torch.data import ImageCollectionDataset, Loader
from pda_torch.data.synthetic import make_dataset_arrays
from pda_torch.models import UNet2d
from pda_torch.train import UNetTrainer

torch.manual_seed(0)
raws, labels = make_dataset_arrays(4, (48, 48), seed=3)
train = ImageCollectionDataset(raws[:3], labels[:3], patch_shape=(32, 32), n_samples=4)
val = ImageCollectionDataset(raws[3:], labels[3:], patch_shape=(32, 32), n_samples=2)
trainer = UNetTrainer("events", UNet2d(depth=2, initial_features=4, final_activation="Sigmoid"),
                      Loader(train, 2, seed=0), Loader(val, 2, seed=1), learning_rate=1e-3,
                      save_root=sys.argv[1], log_image_interval=2, device="cpu")
tb, writes = trainer.logger.tb, []
add_scalar, add_image = tb.add_scalar, tb.add_image
tb.add_scalar = lambda tag, v, step: writes.append(("s", tag, v, step)) or add_scalar(tag, v, step)
tb.add_image = lambda tag, v, step: writes.append(("i", tag, v, step)) or add_image(tag, v, step)
trainer.fit(4)
trainer.logger.close()
with open(sys.argv[2], "wb") as f:
    pickle.dump((trainer.logger.log_dir, writes), f)
print(sorted(m for m in sys.modules if m.split(".")[0] in ("tensorboardX", "tensorboard")))
"""


def test_fit_with_tensorboardx_blocked(tmp_path):
    out = tmp_path / "writes.pkl"
    proc = subprocess.run([sys.executable, "-c", FIT, str(tmp_path / "port"), str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PDA_NATIVE_AUGS": "0", "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "['tensorboardX']"  # blocked, never loaded
    with open(out, "rb") as f:
        log_dir, writes = pickle.load(f)
    tbx = SummaryWriter(str(tmp_path / "tbx"))
    for kind, tag, value, step in writes:
        (tbx.add_scalar if kind == "s" else tbx.add_image)(tag, value, step)
    tbx.close()
    _, _, got = read(log_dir)
    _, _, want = read(str(tmp_path / "tbx"))
    assert_same_events(got, want)
    tags = {tag for _, tag, _, _ in got}
    assert {"train/loss", "validation/loss", "train/input", "validation/prediction"} <= tags
    assert [step for step, tag, _, _ in got if tag == "train/loss"] == [0, 1, 2, 3]

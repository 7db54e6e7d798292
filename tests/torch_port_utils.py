"""Shared set-up for the port's tests (tests/test_torch_*.py): one small
PUNet in ``pda`` (the reference, JAX on the CPU) and the same weights in
``pda_torch`` through the weight bridge."""

from __future__ import annotations

import contextlib
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pda.train.checkpoint import _unpack

torch.set_num_threads(1)  # tier-1 runs several test workers side by side

FILTERS = (4, 8, 12, 16)
LATENT = 6


def seeded_params(model, *inputs, seed: int = 0):
    """Seeded numpy params on the tree of ``model.init(key, *inputs)``.

    The tree's structure and shapes are pda's own (``jax.eval_shape`` of
    ``model.init``, which traces without compiling the initializers); the
    values are seeded normals: He-scaled conv kernels, 1/sqrt(fan_in)-scaled
    Dense kernels and biases of scale 0.1, so that every leaf matters."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)["params"]
    rng = np.random.default_rng(seed)

    def draw(leaf):
        shape = leaf.shape
        if len(shape) == 1:
            scale = 0.1
        else:
            scale = np.sqrt((2.0 if len(shape) == 4 else 1.0) / np.prod(shape[:-1]))
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


@functools.lru_cache(maxsize=None)
def pda_punet(no_convs_fcomb: int = 3, seed: int = 0, consensus_masking: bool = False,
              num_classes: int = 1, no_convs_per_block: int = 3, rl_swap: bool = True):
    """(flax module, params) of a small pda PUNet, posterior included, with
    the flagship's loss settings (beta 1, rl_swap; ``rl_swap=False``: the
    Lung suite's BCE reconstruction); params from :func:`seeded_params`."""
    from pda.models import ProbabilisticUnet

    model = ProbabilisticUnet(num_filters=FILTERS, latent_dim=LATENT,
                              no_convs_fcomb=no_convs_fcomb, beta=1.0, rl_swap=rl_swap,
                              consensus_masking=consensus_masking, num_classes=num_classes,
                              no_convs_per_block=no_convs_per_block)
    x = jnp.zeros((1, 16, 16, 1))
    segm = jnp.zeros((1, 16, 16, num_classes))
    return model, seeded_params(model, x, segm, seed=seed)


def port_punet(params, no_convs_fcomb: int = 3, consensus_masking: bool = False,
               num_classes: int = 1, no_convs_per_block: int = 3, rl_swap: bool = True):
    """The port's PUNet carrying ``params`` (a pda tree), with the loss
    settings of :func:`pda_punet`."""
    from pda_torch.models import ProbabilisticUnet, state_dict_from_pda

    model = ProbabilisticUnet(num_filters=FILTERS, latent_dim=LATENT,
                              no_convs_fcomb=no_convs_fcomb, beta=1.0, rl_swap=rl_swap,
                              consensus_masking=consensus_masking, num_classes=num_classes,
                              no_convs_per_block=no_convs_per_block)
    model.load_state_dict(state_dict_from_pda(params))
    return model.eval()


def t(a) -> torch.Tensor:
    """numpy/jax array -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_close_scaled(out, ref, rel: float = 1e-5) -> None:
    """max |out - ref| <= rel * max(1, max |ref|)."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"max abs err {err} > {tol}"


def assert_consensus_matches(cons, cons_ref, logits_ref, window: float = 1e-5,
                             max_share: float = 1e-3) -> None:
    """Consensus maps agree except at pixels where some sample's logit lies
    within ``window`` of +-log 9 (a threshold); at most ``max_share`` of the
    pixels may be such pixels."""
    cons, cons_ref = np.asarray(cons), np.asarray(cons_ref)
    logits = np.asarray(logits_ref)
    near = (np.abs(np.abs(logits) - np.log(9.0)) < window).any(axis=0)
    assert near.mean() <= max_share, f"{near.mean():.4%} of pixels near a threshold"
    bad = (cons != cons_ref) & ~near
    assert not bad.any(), f"{int(bad.sum())} consensus mismatches away from a threshold"


# ---------------------------------------------------------------------------
# The engine: one small fit of a pda trainer and of the port's on the same
# weights, batches and noise (tests/test_torch_engine*.py)
# ---------------------------------------------------------------------------

ENGINE_LR, ENGINE_BATCH, ENGINE_PATCH, ENGINE_IMAGE = 1e-5, 2, 32, 64
ENGINE_ITERATIONS, ENGINE_LOG_IMAGES = 4, 2  # two epochs of two steps
ENGINE_LAST_SCALE, ENGINE_Z_SCALE = 32.0, 0.02  # the consensus share lies inside (0, 1)
#: trainer kind -> (pda's class and the port's, PUNet (else UNet2d), consensus masking)
ENGINE_KINDS = {
    "unet": ("UNetTrainer", False, False),
    "pseudo_unet": ("PseudoTrainer", False, False),
    "punet": ("PUNetTrainer", True, False),
    "pseudo_punet": ("PseudoTrainerPUNet", True, True),
    "mean_teacher": ("MeanTeacherTrainer", True, True),
    "fixmatch": ("FixMatchTrainer", True, True),
    "adamt": ("AdaMTTrainer", True, True),
    "adamatch": ("AdaMatchTrainer", True, True),
}
ENGINE_SOURCE = (0.7, 0.3)  # FixMatch's source distribution [bg, fg]


def engine_noise(kind: str, b: int):
    """(train, validation, panels): the noise each of pda's callables draws,
    as (port keyword, key index in pda's split of ``state.rng``, shape), and
    the port's panel keywords in the order of pda's ``_panel_keys``. None:
    the steps draw no noise (the UNet trainers)."""
    post, mc, mc8 = (b, LATENT), (16, b, LATENT), (8, b, LATENT)
    if kind in ("unet", "pseudo_unet"):
        return None
    if kind in ("punet", "pseudo_punet"):
        return ([("eps_post", 1, post)], [("eps_post", 1, post), ("eps_mc", 2, mc8)],
                ["eps_samples"])
    label = "eps_teacher" if kind in ("mean_teacher", "adamt") else "eps_weak"
    train = [(label, 1, mc), ("eps_post", 2, post)]
    if kind in ("adamt", "adamatch"):
        train = [("eps_source", 1, post), (label, 2, mc), ("eps_post", 3, post)]
    return train, [(label, 1, mc), ("eps_post", 2, post), ("eps_mc", 3, mc)], [label, "eps_mc"]


class PdaKeyChain:
    """pda's ``state.rng`` as its trainer advances it: seeded as its
    ``initialize`` seeds it, split by every step as the step splits it, so
    that the normals of the keys are the noise pda's steps draw."""

    def __init__(self, seed: int):
        self.rng = jax.random.split(jax.random.PRNGKey(seed))[1]

    def step(self, spec) -> dict:
        keys = jax.random.split(self.rng, max(i for _, i, _ in spec) + 1)
        self.rng = keys[0]
        return {name: t(jax.random.normal(keys[i], shape)) for name, i, shape in spec}

    def panels(self, names) -> dict:
        from pda.train.steps import _panel_keys

        keys = _panel_keys(self.rng, len(names))
        return {name: t(jax.random.normal(k, (16, 1, LATENT))) for name, k in zip(names, keys)}


def recording_logger(cls, name: str, save_root: str):
    """A logger of ``cls`` whose TensorBoard writer (tensorboardX) also keeps
    every scalar and image it writes: ``.scalars`` and ``.images``, lists of
    (tag, step, value)."""
    logger = cls(name, save_root, ENGINE_LOG_IMAGES)
    assert logger.tb is not None, "tensorboardX is needed"
    logger.scalars, logger.images = [], []
    add_scalar, add_image = logger.tb.add_scalar, logger.tb.add_image

    def scalar(tag, value, step):
        logger.scalars.append((tag, step, float(value)))
        add_scalar(tag, value, step)

    def image(tag, img, step):
        logger.images.append((tag, step, np.array(img, dtype=np.float32)))
        add_image(tag, img, step)

    logger.tb.add_scalar, logger.tb.add_image = scalar, image
    return logger


def engine_loaders(data, kind: str, native: bool = False):
    """The trainer's loaders, built from ``data`` (``pda.data`` or
    ``pda_torch.data``, which share one interface) on seeded synthetic
    images: epochs of two batches of two 32^2 patches, one validation
    batch; the weak and strong views are ``pda/experiments/common.py``'s
    numpy recipes, or with ``native`` its native weak recipe."""
    from pda.data.synthetic import make_consensus_arrays, make_dataset_arrays

    raws, labels = make_dataset_arrays(4, (ENGINE_IMAGE, ENGINE_IMAGE), seed=3)
    cons = make_consensus_arrays(labels, seed=4)
    patch = (ENGINE_PATCH, ENGINE_PATCH)
    n = 2 * ENGINE_BATCH
    weak = data.Compose(
        data.standardize, data.RandomApply([data.GaussianBlur()], p=0.25),
        data.RandomApply([data.AdditiveGaussianNoise(scale=(0, 0.15))], p=0.25))
    if native:
        weak = importlib.import_module(data.__name__ + ".native").NativeWeakAugmentation()
    strong = data.Compose(
        data.standardize, data.RandomApply([data.GaussianBlur(sigma=(1.0, 4.0))], p=0.9),
        data.RandomApply([data.AdditiveGaussianNoise(scale=(0.1, 0.35))], p=0.9),
        data.RandomApply([data.RandomContrast(alpha=(0.33, 3), mean=0.0)], p=0.9))

    def plain(k, with_consensus=False):
        return data.ImageCollectionDataset(raws[:k], labels[:k], cons[:k] if with_consensus
                                           else None, patch_shape=patch, n_samples=n, seed=k)

    def dual(k, second=weak):
        return data.DualImageCollectionDataset(raws[:k], labels[:k], patch_shape=patch,
                                               augmentation1=weak, augmentation2=second,
                                               n_samples=n, seed=k)

    def loader(ds, seed):
        return data.Loader(ds, ENGINE_BATCH, seed=seed)

    if kind in ("unet", "punet", "pseudo_unet", "pseudo_punet"):
        consensus = kind.startswith("pseudo")
        return loader(plain(4, consensus), 0), loader(plain(2, consensus), 1)
    second = strong if kind in ("fixmatch", "adamatch") else weak
    if kind in ("mean_teacher", "fixmatch"):
        return loader(dual(4, second), 0), loader(dual(2, second), 1)
    return loader(plain(3), 2), loader(dual(4, second), 0), loader(dual(2, second), 1)


@functools.lru_cache(maxsize=None)
def engine_models(kind: str):
    """(pda module, port module) of the kind's model."""
    _, is_punet, masking = ENGINE_KINDS[kind]
    if is_punet:
        from pda.models import ProbabilisticUnet as JPUNet
        from pda_torch.models import ProbabilisticUnet

        kw = dict(num_filters=FILTERS, latent_dim=LATENT, no_convs_fcomb=3, beta=1.0,
                  rl_swap=True, consensus_masking=masking)
        return JPUNet(**kw), ProbabilisticUnet(**kw)
    from pda.models import UNet2d as JUNet2d
    from pda_torch.models import UNet2d

    return (JUNet2d(depth=2, initial_features=4, final_activation="Sigmoid"),
            UNet2d(depth=2, initial_features=4, final_activation="Sigmoid"))


@contextlib.contextmanager
def numpy_augs(numpy: bool = True):
    """Both packages' numpy transforms, not their native libraries, while
    the block runs (with ``numpy=False``: the native libraries, their
    default)."""
    old = os.environ.get("PDA_NATIVE_AUGS")
    os.environ["PDA_NATIVE_AUGS"] = "0" if numpy else "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PDA_NATIVE_AUGS"]
        else:
            os.environ["PDA_NATIVE_AUGS"] = old


def _trainer_kwargs(kind: str, side) -> dict:
    kw = {}
    if kind in ("mean_teacher", "fixmatch", "adamt", "adamatch"):
        kw["do_consensus_masking"] = True
    if kind == "fixmatch":
        kw["source_distribution"] = (jnp.asarray(ENGINE_SOURCE) if side == "pda"
                                     else ENGINE_SOURCE)
    return kw


@functools.lru_cache(maxsize=None)
def engine_fits(kind: str, save_root: str, native: bool = False) -> dict:
    """pda's trainer and the port's, each through ``fit(4)`` (two epochs of
    two steps, a plateau reduction at the second validation: patience 0 and
    a threshold no metric can pass), from the same weights on the same
    batches (each side's Loader) and the same noise (the port's step and
    panel callables handed the normals of pda's key chain). The weights are
    pda's: its trainer's initialised UNet2d, or for a PUNet the seeded tree
    of :func:`pda_punet` with the Fcomb scaled so that the consensus share
    lies inside (0, 1) (pda's own PUNet init starts with posterior
    log-sigmas up to 6.6 and a KL near 1e5 at this size, where one flipped
    pseudo-label pixel sends the two runs apart). Both sides take their
    numpy augmentations, or with ``native`` their native libraries (the
    weak views too). Returns both trainers, the initial pda tree and the
    port's gradients of every step."""
    import pda.train as jtrain
    import pda_torch.data as tdata
    import pda_torch.train as ttrain
    from pda import data as jdata
    from pda_torch.models import state_dict_from_pda, unet_state_dict_from_pda

    cls_name, is_punet, _ = ENGINE_KINDS[kind]
    jmodel, tmodel = engine_models(kind)
    out = {}
    for side, train_mod, data, model in (("pda", jtrain, jdata, jmodel),
                                         ("port", ttrain, tdata, tmodel)):
        cls = getattr(train_mod, cls_name)
        root = os.path.join(save_root, side + ("_native" if native else ""))
        loaders = engine_loaders(data, kind, native)
        kw = dict(learning_rate=ENGINE_LR, save_root=root, seed=0,
                  lr_scheduler=train_mod.ReduceLROnPlateau(patience=0, threshold=1.0),
                  logger=recording_logger(cls.default_logger_cls, kind, root),
                  log_image_interval=ENGINE_LOG_IMAGES, **_trainer_kwargs(kind, side))
        if side == "port":
            kw["device"] = "cpu"
        out[side] = cls(kind, model, *loaders, **kw)

    jt, tt = out["pda"], out["port"]
    with numpy_augs(not native):
        jt.initialize()
        params = jt.state.params
        if is_punet:  # the seeded tree of the other tests, the Fcomb scaled
            params = pda_punet()[1]
            fc = dict(params["fcomb"])
            fc["last_layer"] = {k: v * ENGINE_LAST_SCALE for k, v in fc["last_layer"].items()}
            fc["z_proj"] = {**fc["z_proj"], "kernel": fc["z_proj"]["kernel"] * ENGINE_Z_SCALE}
            params = jax.tree_util.tree_map(jnp.asarray, {**params, "fcomb": fc})
            jt.state = jt.state.replace(
                params=params, opt_state=jt.tx.init(params),
                teacher_params=(jax.tree_util.tree_map(jnp.array, params) if jt.with_teacher
                                else None))  # a copy: pda's step donates both
        out["init"] = jax.tree_util.tree_map(np.asarray, params)
        jt.fit(ENGINE_ITERATIONS)

    bridge = state_dict_from_pda if is_punet else unet_state_dict_from_pda
    tmodel.load_state_dict(bridge(out["init"]))
    tt.initialize()
    chain, spec = PdaKeyChain(0), engine_noise(kind, ENGINE_BATCH)
    train, val, panels = tt.train_step, tt.val_step, tt.panel_fn
    grads = []

    def train_step(state, *batch, **_):
        noise = chain.step(spec[0]) if spec else {}
        res = train(state, *batch, **noise)
        grads.append({k: p.grad.detach().clone() for k, p in state.model.named_parameters()})
        return res

    def val_step(state, *batch, **_):
        return val(state, *batch, **(chain.step(spec[1]) if spec else {}))

    def panel_fn(model, teacher, *batch, **_):
        return panels(model, teacher, *batch, **(chain.panels(spec[2]) if spec else {}))

    tt.train_step, tt.val_step, tt.panel_fn = train_step, val_step, panel_fn
    with numpy_augs(not native):
        tt.fit(ENGINE_ITERATIONS)
    out["grads"] = grads
    out["bridge"] = bridge
    return out


# the engine tests' checks, one per test of tests/test_torch_engine*.py


def _logged(logger, prefix):
    return {(tag, step): v for tag, step, v in logger.scalars if tag.startswith(prefix)}


def check_scalars(kind, root, prefix, native=False):
    fits = engine_fits(kind, root, native)
    want, got = _logged(fits["pda"].logger, prefix), _logged(fits["port"].logger, prefix)
    assert sorted(got) == sorted(want)
    assert want, "no scalar logged"
    for key, v in want.items():
        if got[key] != v:  # equal infinities pass
            rel = 1e-6 if key[0].endswith("learning_rate") else 1e-5
            assert_close_scaled(got[key], v, rel=rel)
    return fits


def check_train_scalars(kind, root, native=False):
    fits = check_scalars(kind, root, "train/", native)
    # every step logged once, one step late, the last one without the rate
    port = fits["port"]
    assert [i for i, _ in port.history] == list(range(ENGINE_ITERATIONS))
    assert "learning_rate" not in port.history[-1][1]


def check_validation_scalars(kind, root, native=False):
    fits = check_scalars(kind, root, "validation/", native)
    assert [i for i, _ in fits["port"].val_history] == [2, 4]


def _noisy(fits) -> dict:
    """Per leaf, where some step's gradient leaves Adam's sign to rounding
    noise: within 1e-5 of the leaf's largest, or a UNet sampler's bias (the
    InstanceNorm after it takes it out: its exact gradient is 0)."""
    noisy = {}
    for grads in fits["grads"]:
        for name, g in grads.items():
            g = g.abs().numpy()
            zero = name.startswith("decoder.samplers.") and name.endswith(".bias")
            noisy[name] = noisy.get(name, False) | (g <= 1e-5 * g.max()) | zero
    return noisy


def check_final_weights(kind, root, native=False):
    fits = engine_fits(kind, root, native)
    jt, tt, bridge = fits["pda"], fits["port"], fits["bridge"]
    noisy, init = _noisy(fits), {k: v.numpy() for k, v in bridge(fits["init"]).items()}
    pairs = [(jt.state.params, tt.state.model)]
    if ENGINE_KINDS[kind][0] in ("MeanTeacherTrainer", "AdaMTTrainer"):
        pairs.append((jt.state.teacher_params, tt.state.teacher))
    bound = ENGINE_ITERATIONS * ENGINE_LR * (1 + 1e-6)
    for tree, module in pairs:
        want = {k: v.numpy() for k, v in bridge(jax.tree_util.tree_map(np.asarray, tree)).items()}
        got = {k: v.detach().numpy() for k, v in module.state_dict().items()}
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            # abs 1e-6 above float32's own rounding of the weight (4 ulps):
            # the EMA's products round in either order
            ulps = 4 * np.spacing(np.abs(w))
            err = np.abs(got[name] - w) - ulps
            assert err[~noisy[name]].max(initial=0.0) <= 1e-6, name
            moved = np.abs(got[name] - init[name]) - ulps
            assert moved[noisy[name]].max(initial=0.0) <= bound, name
    moved = [np.abs(p.detach().numpy() - init[n]).max() > 0
             for n, p in tt.state.model.named_parameters()]
    assert all(moved)


def check_iteration_lr_and_checkpoints(kind, root, native=False):
    fits = engine_fits(kind, root, native)
    jt, tt = fits["pda"], fits["port"]
    assert jt._iteration == tt._iteration == tt.state.step == int(jt.state.step) == 4
    # patience 0 and threshold 1: the second validation cannot improve
    assert tt.state.learning_rate == pytest.approx(0.9 * ENGINE_LR, rel=1e-12)
    assert jt.state.learning_rate == pytest.approx(tt.state.learning_rate, rel=1e-6)
    assert tt._best_metric == pytest.approx(jt._best_metric, rel=1e-5)
    for which in ("best", "latest"):
        with open(os.path.join(jt.ckpt_dir, f"{which}.ckpt"), "rb") as f:
            meta = _unpack(f.read())[1]
        blob = torch.load(os.path.join(tt.ckpt_dir, f"{which}.pt"), weights_only=True)
        assert blob["iteration"] == meta["step"]
        for key in ("best_metric", "current_metric"):
            assert blob[key] == pytest.approx(meta[key], rel=1e-5)
        assert blob["scheduler_state"]["num_bad_epochs"] == meta["lr_scheduler"]["num_bad_epochs"]
        assert blob["scheduler_state"]["best"] == pytest.approx(meta["lr_scheduler"]["best"],
                                                                rel=1e-5)
        assert ("teacher_state" in blob) == meta["has_teacher"]
    assert blob["iteration"] == 4  # latest
    assert blob["best_metric"] == min(m["metric"] for _, m in tt.val_history)
    assert sorted(os.listdir(tt.ckpt_dir)) == ["best.pt", "latest.pt"]


def check_tags_and_panels(kind, root, native=False):
    fits = engine_fits(kind, root, native)
    jt, tt = fits["pda"], fits["port"]
    assert ({tag for tag, _, _ in tt.logger.scalars}
            == {tag for tag, _, _ in jt.logger.scalars})
    want = {(tag, step): img for tag, step, img in jt.logger.images}
    got = {(tag, step): img for tag, step, img in tt.logger.images}
    assert sorted(got) == sorted(want)
    for prefix in ("train/", "validation/"):
        tags = {tag[len(prefix):] for tag, _ in got if tag.startswith(prefix)}
        assert tags == set(jt.image_tags) == set(tt.image_tags)
    assert {step for tag, step in got if tag.startswith("train/")} == {0, 2}
    for key, img in want.items():
        assert_close_scaled(got[key], img, rel=1e-5)

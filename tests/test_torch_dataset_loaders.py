"""The port's eleven dataset loaders against the JAX package's.

Each case runs one test of ``tests/test_dataset_loaders.py`` (the same
fabricated on-disk layouts and assertions) on the port's registry, and
every dataset it builds is also built by the JAX loader on a copy of the
same tree: the parsed splits (relative image paths, labels, classnames)
must be equal. The loaders are copies; each is pinned to its original
(AST equal once docstrings are dropped).
"""

import ast
import os.path as osp
import shutil
import sys
import tempfile

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

import test_dataset_loaders as jax_tests  # noqa: E402

LOADERS = ("dtd", "eurosat", "fgvc_aircraft", "food101", "imagenet",
           "imagenet_variants", "oxford_flowers", "oxford_pets",
           "stanford_cars", "sun397", "ucf101")


def _code(path):
    """The module's AST with every docstring dropped."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(
                body[0], ast.Expr) and isinstance(
                getattr(body[0], "value", None), ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", LOADERS)
def test_port_loader_is_pinned_to_the_original(name):
    assert _code(osp.join(REPO, "clip_calibration_tpu_torch", "data",
                          "datasets", name + ".py")) == \
        _code(osp.join(REPO, "clip_calibration_tpu", "data", "datasets",
                       name + ".py"))


def _rows(ds, *roots):
    """Per split, (image path relative to the root it lies under, label,
    classname); a copied cache keeps the paths of the tree it was made
    in, hence several roots."""
    def rel(path):
        root = next(r for r in roots if path.startswith(r + osp.sep))
        return osp.relpath(path, root)
    return {split: [(rel(x.impath), x.label, x.classname)
                    for x in getattr(ds, split)]
            for split in ("train_x", "val", "test")}


def _build_both(name, root):
    """The port's dataset on ``root``, held to the JAX package's on a
    copy of the tree as it stands before either builds."""
    from clip_calibration_tpu.data.base import (
        set_random_seed as jax_seed)
    from clip_calibration_tpu.engine.registry import (
        DATASET_REGISTRY as JAX_REGISTRY)
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.base import set_random_seed
    from clip_calibration_tpu_torch.engine.registry import DATASET_REGISTRY
    import clip_calibration_tpu_torch.data.datasets  # noqa: F401

    copy = tempfile.mkdtemp(prefix="jax_loader_")
    try:
        shutil.copytree(root, copy, dirs_exist_ok=True)
        jax_seed(1)
        want = _rows(JAX_REGISTRY.get(name)(jax_tests._cfg(copy)), copy,
                     str(root))
    finally:
        shutil.rmtree(copy, ignore_errors=True)
    cfg = get_cfg_default()
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NUM_SHOTS = -1
    cfg.DATASET.SUBSAMPLE_CLASSES = "all"
    cfg.SEED = 1
    set_random_seed(1)
    ds = DATASET_REGISTRY.get(name)(cfg)
    assert type(ds).__module__.startswith("clip_calibration_tpu_torch.")
    assert _rows(ds, str(root)) == want, name
    return ds


@pytest.mark.parametrize("case", sorted(
    n for n in dir(jax_tests) if n.startswith("test_")))
def test_port_loader(case, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_tests, "_build", _build_both)
    getattr(jax_tests, case)(tmp_path)

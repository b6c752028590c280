"""The port's calibration path against the JAX package: device scoring,
KNN proximity, the copied framework-free modules (pinned to the JAX
package's golden fixtures), config merging, registries, data loading, and
feature caches / checkpoints moving between the two packages."""

import glob
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_calibration_tpu.ops import scoring as JS
from clip_calibration_tpu.trainers.calibration import proximity as JP
from clip_calibration_tpu_torch.ops import scoring as TS
from clip_calibration_tpu_torch.trainers.calibration import proximity as TP
from clip_calibration_tpu_torch.trainers.calibration.dac import (
    DistanceAwareCalibration)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIX = osp.join(REPO, "tests", "fixtures")


def _features(seed, nb=20, nc=12, d=32):
    rng = np.random.default_rng(seed)
    base_zs = rng.normal(size=(nb, d))
    base_zs /= np.linalg.norm(base_zs, axis=1, keepdims=True)
    cur_zs = rng.normal(size=(nc, d))
    cur_zs /= np.linalg.norm(cur_zs, axis=1, keepdims=True)
    base_t = base_zs + rng.normal(size=(nb, d)) * 0.1
    cur_t = cur_zs + rng.normal(size=(nc, d)) * 0.1
    cur_t[0] = base_t[3]  # base-class-aware case
    return [a.astype(np.float32) for a in (base_zs, cur_zs, base_t, cur_t)]


# ------------------------------------------------------------- scoring

@pytest.mark.parametrize("k", [5, 30])
def test_dac_class_confidence_matches_jax(k):
    feats = _features(0)
    want = JS.dac_class_confidence(*(jnp.asarray(a) for a in feats), k=k)
    got = TS.dac_class_confidence(*(torch.from_numpy(a) for a in feats),
                                  k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _clip_width_features(seed, nb, nc, d=768):
    """Unit-norm zero-shot and tuned text features at CLIP's width, in
    float64."""
    rng = np.random.default_rng(seed)
    base_zs, cur_zs = _unit(rng.normal(size=(nb, d))), _unit(
        rng.normal(size=(nc, d)))
    base_t = _unit(base_zs + rng.normal(size=(nb, d)) * 0.03)
    cur_t = _unit(cur_zs + rng.normal(size=(nc, d)) * 0.03)
    return base_zs, cur_zs, base_t, cur_t


@pytest.mark.parametrize("nb,nc,case", [(64, 48, None),
                                        (4, 48, None),
                                        (64, 48, "copied_base"),
                                        (64, 48, "near_zero_shot_base")],
                         ids=["64x48", "fewer_bases_than_k", "copied_base",
                              "near_zero_shot_base"])
def test_dac_fit_matches_jax_numpy_fit(nb, nc, case):
    """The port's float64 device fit against the JAX package's numpy fit
    at CLIP's width (768), k 5. A zero-shot current feature 1e-7 from a
    base one holds the fit to the difference form: the Gram expansion
    loses about a percent of that distance to cancellation."""
    from clip_calibration_tpu.trainers.calibration.dac import (
        DistanceAwareCalibration as JaxDAC)
    feats = _clip_width_features(5, nb, nc)
    copy_base = case == "copied_base"
    if copy_base:
        feats[3][7] = feats[2][11]  # a current class that is a base one
    if case == "near_zero_shot_base":
        u = _unit(np.random.default_rng(8).normal(size=feats[0].shape[1]))
        feats[1][5] = feats[0][9] + 1e-7 * u
    want, got = JaxDAC(), DistanceAwareCalibration()
    want.fit(*feats, k=5)
    got.fit(*feats, k=5, device="cpu")
    assert got.class_confidence.dtype == np.float64
    if copy_base:
        assert got.class_confidence[7] == 1.0
    np.testing.assert_allclose(got.class_confidence, want.class_confidence,
                               rtol=1e-12, atol=0)


def test_dac_base_threshold_in_float64():
    """Current rows at 0.05 - 1e-9 and 0.05 + 1e-9 from their nearest
    tuned base feature fall on either side of the base-class threshold; a
    float32 fit cannot resolve the 2e-9 between them."""
    base_zs, cur_zs, base_t, cur_t = _clip_width_features(6, 64, 8)
    rng = np.random.default_rng(7)
    for row, r in ((0, 0.05 - 1e-9), (1, 0.05 + 1e-9)):
        u = _unit(rng.normal(size=base_t.shape[1]))
        cur_t[row] = base_t[row] + r * u
    np.testing.assert_allclose(
        np.linalg.norm(cur_t[:2] - base_t[:2], axis=1),
        [0.05 - 1e-9, 0.05 + 1e-9], rtol=0, atol=1e-13)
    dac = DistanceAwareCalibration()
    dac.fit(base_zs, cur_zs, base_t, cur_t, k=5, device="cpu")
    assert dac.class_confidence[0] == 1.0
    assert dac.class_confidence[1] != 1.0


def test_dac_class_confidence_is_float64_for_float32_inputs():
    got = TS.dac_class_confidence(*(torch.from_numpy(a)
                                    for a in _features(0)), k=5)
    assert got.dtype == torch.float64


@pytest.mark.parametrize("normalized", [False, True])
def test_fused_dac_scores_matches_jax(normalized):
    rng = np.random.default_rng(1)
    img = rng.normal(size=(16, 32)).astype(np.float32)
    txt = rng.normal(size=(12, 32)).astype(np.float32)
    if normalized:
        img /= np.linalg.norm(img, axis=1, keepdims=True)
        txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    conf = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    wp, wl = JS.fused_dac_scores(jnp.asarray(img), jnp.asarray(txt),
                                 jnp.asarray(np.float32(2.0)),
                                 jnp.asarray(conf), normalized=normalized)
    gp, gl = TS.fused_dac_scores(torch.from_numpy(img),
                                 torch.from_numpy(txt), torch.tensor(2.0),
                                 torch.from_numpy(conf),
                                 normalized=normalized)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-4,
                               atol=1e-6)


def test_knn_dists_match_jax():
    rng = np.random.default_rng(2)
    base = rng.normal(size=(100, 16)).astype(np.float32)
    cur = rng.normal(size=(37, 16)).astype(np.float32)
    np.testing.assert_allclose(
        TP.get_knn_dists(base, cur, 5, chunk=16, device="cpu"),
        JP.get_knn_dists(base, cur, 5, chunk=16), rtol=1e-4, atol=1e-4)
    # k clamps to a tiny base set
    assert TP.get_knn_dists(base[:3], cur, 5, device="cpu").shape == (37, 3)


def test_val_self_knn_matches_jax():
    feats = np.random.default_rng(3).normal(size=(50, 8)).astype(
        np.float32)
    got = TP.get_val_image_knn_dists(feats, 3, device="cpu")
    np.testing.assert_allclose(got, JP.get_val_image_knn_dists(feats, 3),
                               rtol=1e-4, atol=1e-4)
    assert np.all(got > 0)  # self excluded
    with pytest.raises(ValueError):
        TP.get_val_image_knn_dists(feats[:1], 3, device="cpu")


# ------------------------------------------------------ copies vs golden

def test_tokenizer_matches_golden():
    from clip_calibration_tpu_torch.models.tokenizer import CLIPTokenizer
    with open(osp.join(FIX, "tokenizer_golden.json")) as f:
        golden = json.load(f)
    tok = CLIPTokenizer()
    assert (tok.vocab_size, tok.sot_id, tok.eot_id) == (
        golden["vocab_size"], golden["sot"], golden["eot"])
    for case in golden["cases"]:
        assert tok.encode(case["text"]) == case["tokens"], case["text"]
        assert tok.decode(case["tokens"]) == case["decoded"], case["text"]


def test_metrics_match_golden():
    from clip_calibration_tpu_torch.tools.metrics import (ECE, MCE,
                                                          AdaptiveECE,
                                                          PIECE)
    with open(osp.join(FIX, "metrics_golden.json")) as f:
        cases = json.load(f)
    for c in cases:
        conf, pred, gt, prox = (np.array(c[k]) for k in
                                ("conf", "pred", "gt", "prox"))
        assert ECE(conf, pred, gt, 10) == pytest.approx(c["ece"], abs=1e-12)
        assert MCE(conf, pred, gt, 10) == pytest.approx(c["mce"], abs=1e-12)
        assert AdaptiveECE(conf, pred, gt, c.get("ace_bins", 10)) == \
            pytest.approx(c["ace"], abs=1e-12)
        assert PIECE(conf, prox, pred, gt, c.get("piece_dist_bins", 10),
                     10) == pytest.approx(c["piece"], abs=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax_sklearn_binning(seed):
    """The port bins ACE/PIECE in numpy; the JAX package calls
    scikit-learn. Ties and a constant proximity included."""
    from clip_calibration_tpu.tools import metrics as JMet
    from clip_calibration_tpu_torch.tools import metrics as TMet
    rng = np.random.default_rng(seed)
    n = 97
    conf = np.round(rng.uniform(0.1, 1.0, n), 2)  # ties
    pred = rng.integers(0, 4, n)
    gt = np.where(rng.random(n) < conf, pred, rng.integers(0, 4, n))
    for prox in (rng.random(n), np.round(rng.random(n), 1),
                 np.full(n, 0.5)):
        assert TMet.AdaptiveECE(conf, pred, gt, 10) == pytest.approx(
            JMet.AdaptiveECE(conf, pred, gt, 10), abs=1e-12)
        for strategy in ("quantile", "uniform"):
            assert TMet.PIECE(conf, prox, pred, gt, 10, 10, strategy) == \
                pytest.approx(JMet.PIECE(conf, prox, pred, gt, 10, 10,
                                         strategy), abs=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_macro_f1_matches_sklearn(seed):
    from sklearn.metrics import f1_score
    from clip_calibration_tpu_torch.evaluators.vl_evaluator import macro_f1
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 6, 50)
    preds = np.where(rng.random(50) < 0.5, labels, rng.integers(0, 8, 50))
    assert macro_f1(labels, preds) == pytest.approx(
        f1_score(labels, preds, average="macro", labels=np.unique(labels)),
        abs=1e-12)


def test_dac_matches_golden():
    with open(osp.join(FIX, "dac_golden.json")) as f:
        g = json.load(f)
    dac = DistanceAwareCalibration()
    dac.fit(np.array(g["base_zs"]), np.array(g["cur_zs"]),
            np.array(g["base_t"]), np.array(g["cur_t"]), k=g["k"],
            device="cpu")
    np.testing.assert_allclose(dac.class_confidence,
                               np.array(g["class_confidence"]),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["histogram_binning", "isotonic_regression",
                                  "multi_isotonic_regression"])
def test_bin_calibrators_match_jax(name):
    from clip_calibration_tpu.trainers.calibration import binning as JB
    from clip_calibration_tpu_torch.trainers.calibration import binning as TB
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(200, 5)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    labels = rng.integers(0, 5, 200)
    out = []
    for mod in (JB, TB):
        cls = {"histogram_binning": mod.HistogramBinning,
               "isotonic_regression": mod.IsotonicRegression,
               "multi_isotonic_regression": mod.MultiIsotonicRegression}[name]
        cal = cls(bins=10) if name == "histogram_binning" else cls()
        if name == "multi_isotonic_regression":
            cal.fit_transform(probs, labels)
        else:
            cal.fit(probs, labels)
        out.append(cal.transform(probs))
    # the JAX package fits with scikit-learn, the port with its own numpy
    # isotonic regression (same algorithm, same order of operations), so
    # the two may part in the last bit where sums are taken in another
    # order; 1e-12 leaves room for that and for nothing else
    np.testing.assert_allclose(out[1], out[0], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("strategy", ["kmeans", "quantile", "uniform"])
@pytest.mark.parametrize("name", ["histogram_binning", "isotonic_regression",
                                  "multi_isotonic_regression"])
def test_bin_mean_shift_matches_jax(name, strategy):
    """BinMeanShift (the port's numpy k-means and isotonic fits against
    scikit-learn's in the JAX package), fit and transform, with tied
    proximities."""
    from clip_calibration_tpu.trainers.calibration import bin_mean_shift as JM
    from clip_calibration_tpu.trainers.calibration import binning as JB
    from clip_calibration_tpu_torch.trainers.calibration import (
        bin_mean_shift as TM)
    from clip_calibration_tpu_torch.trainers.calibration import binning as TB
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(300, 6)) * 2
    labels = rng.integers(0, 6, 300)
    prox = np.round(np.exp(-rng.random(300) * 3) ** 2, 3)
    test_logits, test_prox = logits[:120] * 1.3, prox[:120] * 0.9 + 0.05
    out = []
    for mod, binning in ((JM, JB), (TM, TB)):
        method = {"histogram_binning": binning.HistogramBinning,
                  "isotonic_regression": binning.IsotonicRegression,
                  "multi_isotonic_regression":
                      binning.MultiIsotonicRegression}[name]
        kwargs = {"bins": 10} if name == "histogram_binning" else {}
        cal = mod.BinMeanShift(name, method, bin_strategy=strategy,
                               proximity_bin=7, **kwargs)
        fitted = cal.fit_transform(logits, prox, labels)
        out.append((cal.bin_edges, fitted,
                    cal.transform(test_logits, test_prox)))
    for want, got in zip(*out):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_kmeans_1d_matches_sklearn_relocating_empty_clusters():
    """More centres than the data fills: scikit-learn relocates the empty
    clusters to the farthest points; so does the port."""
    from sklearn.cluster import KMeans
    from clip_calibration_tpu_torch.trainers.calibration.bin_mean_shift \
        import kmeans_1d
    x = np.r_[np.zeros(20), np.full(5, 0.9), [0.5, 1.0, 0.93]]
    init = np.linspace(0.0, 0.2, 6)
    want = KMeans(n_clusters=6, init=init[:, None], n_init=1).fit(
        x[:, None]).cluster_centers_[:, 0]
    np.testing.assert_allclose(kmeans_1d(x, init), want, rtol=1e-12,
                               atol=1e-12)


# ------------------------------------------------------------- configs

CONFIGS = sorted(glob.glob(osp.join(REPO, "configs", "**", "*.yaml"),
                           recursive=True))


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[osp.relpath(p, REPO) for p in CONFIGS])
def test_every_config_merges_into_port_defaults(path):
    from clip_calibration_tpu_torch.config import get_cfg_default
    cfg = get_cfg_default()
    cfg.merge_from_file(path)


def test_port_defaults_equal_jax_defaults():
    from clip_calibration_tpu.config import get_cfg_default as jax_cfg
    from clip_calibration_tpu_torch.config import get_cfg_default
    assert str(get_cfg_default()) == str(jax_cfg())


def test_registries_do_not_collide():
    import clip_calibration_tpu.data.datasets  # noqa: F401
    import clip_calibration_tpu.trainers  # noqa: F401
    import clip_calibration_tpu_torch.data.datasets  # noqa: F401
    import clip_calibration_tpu_torch.trainers  # noqa: F401
    from clip_calibration_tpu.engine import registry as JR
    from clip_calibration_tpu_torch.engine import registry as TR
    for reg, name in ((("TRAINER_REGISTRY"), "CoOp"),
                      ("TRAINER_REGISTRY", "ZeroshotCLIP"),
                      ("DATASET_REGISTRY", "Caltech101"),
                      ("DATASET_REGISTRY", "Synthetic")):
        j, t = getattr(JR, reg).get(name), getattr(TR, reg).get(name)
        assert j is not t
        assert t.__module__.startswith("clip_calibration_tpu_torch.")


# ---------------------------------------------------------------- data

def test_data_manager_matches_jax(tmp_path):
    """Same synthetic split, same eval batches from both loaders."""
    from clip_calibration_tpu.config import get_cfg_default as jax_cfg
    from clip_calibration_tpu.data.loader import DataManager as JDM
    import clip_calibration_tpu.data.datasets  # noqa: F401
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.loader import DataManager as TDM
    import clip_calibration_tpu_torch.data.datasets  # noqa: F401

    batches = []
    for get_cfg, DM in ((jax_cfg, JDM), (get_cfg_default, TDM)):
        cfg = get_cfg()
        cfg.merge_from_file(osp.join(REPO, "configs", "datasets",
                                     "synthetic.yaml"))
        cfg.merge_from_list(["DATASET.ROOT", str(tmp_path),
                             "DATASET.NUM_SHOTS", "4", "SEED", "1",
                             "INPUT.SIZE", "(32, 32)",
                             "DATALOADER.TEST.BATCH_SIZE", "16",
                             "DATASET.SUBSAMPLE_CLASSES", "new"])
        dm = DM(cfg)
        batches.append((dm.dataset.classnames, list(dm.test_loader),
                        [d.impath for d in dm.dataset.train_x]))
    (jc, jb, jt), (tc, tb, tt) = batches
    assert jc == tc and jt == tt and len(jb) == len(tb)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["label"], b["label"])
        assert a["n_real"] == b["n_real"]


# ------------------------------------------- files shared by the packages

def _vals():
    rng = np.random.default_rng(5)
    return {"val_logits": rng.normal(size=(6, 3)).astype(np.float32),
            "val_image_features": rng.normal(size=(6, 4)).astype(np.float32),
            "val_text_features": rng.normal(size=(3, 4)).astype(np.float32),
            "val_labels": np.array([0, 1, 2, 0, 1, 2], np.int32),
            "val_image_knn_dists": rng.random((6, 2)).astype(np.float32)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_feature_cache_moves_between_packages(tmp_path, writer):
    from clip_calibration_tpu.trainers import base_learner as JB
    from clip_calibration_tpu_torch.trainers import base_learner as TB
    src, dst = (JB, TB) if writer == "jax" else (TB, JB)
    path = str(tmp_path / "base_features.pt")
    want = _vals()
    src._save_feature_dict(path, want)
    got = dst._load_feature_dict(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_moves_between_packages(tmp_path, writer):
    import ml_dtypes
    from clip_calibration_tpu.engine import checkpoint as JC
    from clip_calibration_tpu_torch.engine import checkpoint as TC
    ctx = np.random.default_rng(6).normal(size=(4, 8)).astype(np.float32)
    bf = ctx.astype(ml_dtypes.bfloat16)
    if writer == "jax":
        path = JC.save_checkpoint({"state_dict": {"ctx": ctx, "p": {"b": bf}},
                                   "epoch": 3}, str(tmp_path), 3)
        ck = TC.load_checkpoint(path)
        got_ctx = ck["state_dict"]["ctx"].numpy()
        got_bf = ck["state_dict"]["p"]["b"].float().numpy()
        assert ck["state_dict"]["p"]["b"].dtype == torch.bfloat16
    else:
        path = TC.save_checkpoint(
            {"state_dict": {"ctx": torch.from_numpy(ctx),
                            "p": {"b": torch.from_numpy(ctx).bfloat16()}},
             "epoch": 3}, str(tmp_path), 3)
        ck = JC.load_checkpoint(path)
        got_ctx = ck["state_dict"]["ctx"]
        got_bf = np.asarray(ck["state_dict"]["p"]["b"], np.float32)
        assert str(ck["state_dict"]["p"]["b"].dtype) == "bfloat16"
    assert ck["epoch"] == 3 and ck["native"]
    np.testing.assert_array_equal(got_ctx, ctx)
    np.testing.assert_array_equal(got_bf, bf.astype(np.float32))


def test_reference_torch_checkpoint_loads_and_exports(tmp_path):
    from clip_calibration_tpu.engine import checkpoint as JC
    from clip_calibration_tpu_torch.engine import checkpoint as TC
    ref = osp.join(FIX, "golden_e2e", "coop_model", "prompt_learner",
                   "model.pth.tar-3")
    ck = TC.load_checkpoint(ref)
    want = JC.load_checkpoint(ref)
    assert not ck["native"] and ck["epoch"] == want["epoch"]
    np.testing.assert_array_equal(ck["state_dict"]["ctx"].numpy(),
                                  want["state_dict"]["ctx"])
    out = TC.export_torch_checkpoint(ck["state_dict"], ck["epoch"],
                                     str(tmp_path / "model.pth.tar-3"))
    back = JC.load_checkpoint(out)
    np.testing.assert_array_equal(back["state_dict"]["ctx"],
                                  want["state_dict"]["ctx"])
    assert os.path.getsize(out) > 0

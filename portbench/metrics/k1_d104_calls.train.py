"""K1 launches at head dim 104 per untraced CoOp step: the program's k1.calls.d104 count (ops/mha_qkv.py, one per launch) over its train.step count, both written only with no profiler running, so over the same steps (set-up's checked steps and the window's untraced ones). ViT-bigG/14 launches one a vision layer, 48 a step; fewer says the vision attention left the kernel."""


def read(reading):
    try:
        from clip_calibration_tpu_torch.tools.profiling import snapshot
    except ImportError:
        return None
    snap = snapshot()
    calls, steps = snap.get("k1.calls.d104"), snap.get("train.step")
    if calls is None or steps is None or steps["count"] == 0:
        return None
    return calls["total"] / steps["count"]

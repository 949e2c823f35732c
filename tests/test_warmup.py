"""The compile warm-up must enumerate tasks whose (signature, static-arg)
keys match what the driver actually calls — a task that throws would
silently waste a compile slot (CompileWarmer counts it in `failed`).  Run every task synchronously on CPU at a small geometry and
assert zero failures."""

import numpy as np

from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline, PipelineConfig
from bundleadjustment_tpu.pipeline.warmup import CompileWarmer


def test_all_warmup_tasks_execute():
    cfg = PipelineConfig(
        init_type="gtdepth", estimation="ba", local_ba=True,
        n_features=64, n_levels=2, track_batch=2,
    )
    K4 = np.array([150.0, 150.0, 80.0, 60.0], np.float32)
    pipe = BundleAdjustmentPipeline(cfg, K4, 160, 120)
    warmer = CompileWarmer(pipe, n_threads=2)
    tasks = warmer._build_tasks()
    assert len(tasks) > 20
    # the dense/flat BA ladder families share one closure each — executing
    # ONE bucket per family validates the signature without compiling ~30
    # full LM scans on XLA:CPU (which has segfaulted flakily under that
    # much sequential LLVM work in one process)
    seen_family = set()
    failures = []
    for name, task in tasks:
        family = name.split("_")[0] if name[-1].isdigit() else name
        if family in ("dense", "flat") and family in seen_family:
            continue
        seen_family.add(family)
        try:
            task()
        except Exception as e:  # noqa: BLE001 - collecting for the assert
            failures.append((name, repr(e)))
    assert not failures, failures

    # the warm shapes must match what the driver actually dispatches: a
    # warm-up at the wrong keypoint capacity succeeds but compiles useless
    # buckets (exactly the bug this guards against) — the REAL frontend
    # call after warm-up must be a jit-cache HIT, not a new trace
    from bundleadjustment_tpu.pipeline import driver as drv

    n_before = drv._frontend_jit._cache_size()
    feats = pipe.detect(np.zeros((120, 160), np.float32))
    pipe.detect_and_match(np.zeros((120, 160), np.float32), feats)
    assert drv._frontend_jit._cache_size() == n_before


def test_warmup_skips_on_cpu_backend():
    cfg = PipelineConfig(n_features=64, n_levels=2)
    K4 = np.array([150.0, 150.0, 80.0, 60.0], np.float32)
    pipe = BundleAdjustmentPipeline(cfg, K4, 160, 120)
    w = CompileWarmer(pipe).start()  # backend is cpu: no threads
    assert w._threads == []

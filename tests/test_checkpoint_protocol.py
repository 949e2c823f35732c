"""Protocol-shaped checkpoint/resume equivalence in a FRESH process
(round-4 VERDICT #5, CPU-sized variant of the config-6r protocol).

A config-6-shaped run (layered scene, keyframes, local BA, culling,
guided-refinement finalize) is interrupted mid-sequence, checkpointed, and
resumed by `protocols.checkpoint_resume_worker` in a subprocess; the
resumed run's final ATE must land within tolerance of the uninterrupted
run.  The tolerance covers the documented feats-not-checkpointed fallback
(`pipeline/checkpoint.py`): frames tracked before the cut lose guided
re-association at finalize.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bundleadjustment_tpu.data.synthetic import render_layered_scene
from bundleadjustment_tpu.metrics import evaluate_ate
from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline, PipelineConfig
from bundleadjustment_tpu.pipeline.checkpoint import save_checkpoint
from protocols import make_dataset

RENDER_KW = dict(
    n_frames=60, width=320, height=240, fx=262.0, fy=262.0,
    trajectory="sweep", motion_step=0.05, rot_step=0.012, seed=16,
)
CFG_KW = dict(
    init_type="gtdepth", estimation="ba", local_ba=True, cull_frames=True,
    n_features=600, n_levels=4,
)


@pytest.mark.slow
def test_checkpoint_resume_fresh_process_protocol(tmp_path):
    cfg = PipelineConfig(**CFG_KW)
    frames, K4 = render_layered_scene(**RENDER_KW)
    ds = make_dataset(frames)
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])

    pipe = BundleAdjustmentPipeline(cfg, K4, 320, 240)
    pipe.process_frames(ds[:30])
    ckpt = str(tmp_path / "state.npz")
    save_checkpoint(ckpt, pipe)

    # uninterrupted continuation (the comparison run)
    pipe.process_frames(ds[30:])
    pipe.finalize()
    ts, mats = pipe.trajectory_cam_to_world()
    ate_straight = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)["rmse"]

    spec = {
        "ckpt": ckpt, "scene": "layered", "render": RENDER_KW,
        "cfg": CFG_KW, "start": 30, "platform": "cpu",
        "out": str(tmp_path / "resume.json"),
    }
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import protocols; protocols.checkpoint_resume_worker({spec_path!r})"],
        cwd=repo, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(spec["out"]) as f:
        resumed = json.load(f)

    assert resumed["frames_tracked"] == len(ds)
    bound = 0.05  # the BASELINE protocol ATE bound
    assert ate_straight < bound, ate_straight
    assert resumed["ate_rmse_m"] < bound, resumed
    # equivalence up to the documented degraded-finalize effect
    assert abs(resumed["ate_rmse_m"] - ate_straight) < max(
        0.6 * ate_straight, 0.01), (resumed["ate_rmse_m"], ate_straight)


def test_main_runs_child_protocols_first(monkeypatch, capsys):
    """`protocols.main` runs the protocols whose work runs in child
    processes before any in-process one, so the parent has not yet taken
    the device when the children need it; a child protocol's own `device`
    field is kept."""
    import protocols

    order = []

    def fake(name, device=None):
        def fn(seed=None):
            order.append((name, seed))
            return {"metric": name} | ({"device": device} if device else {})
        return fn

    monkeypatch.setattr(protocols, "PROTOCOLS", {
        "1": fake("1"), "2": fake("2"), "6r": fake("6r", device="child-dev"),
    })
    protocols.main(["2", "1:111", "6r"])
    assert order == [("6r", None), ("2", None), ("1", 111)]
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"metric": "6r", "device": "child-dev"}
    assert all("device" in ln for ln in lines)
    with pytest.raises(SystemExit):
        protocols.main(["sweep", "1", "6r"])

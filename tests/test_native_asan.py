"""ASan/UBSan smoke test of the native map store.

The reference compiles AddressSanitizer into every Debug build
(ba_project/CMakeLists.txt:32-40); this framework's equivalent risk
surface is libmapstore's C ABI (raw pointers + caller-sized buffers via
ctypes), so CI builds an instrumented `libmapstore_asan.so` and drives the
full API from a subprocess with the sanitizer runtime preloaded.
"""

import os
import subprocess
import sys

import pytest

NATIVE_DIR = os.path.join(
    os.path.dirname(__file__), "..", "bundleadjustment_tpu", "native"
)

EXERCISE = r"""
import ctypes, numpy as np
import bundleadjustment_tpu.native as native

# point the loader at the instrumented build
native._SO = native._SO.replace("libmapstore.so", "libmapstore_asan.so")

from bundleadjustment_tpu.mapstate import SceneMap

m = SceneMap(max_frames=16, max_points=256, max_kp=32, K4=[100, 100, 50, 50])
rng = np.random.default_rng(0)
slots = []
for i in range(6):
    n_kp = 32 if i % 2 == 0 else 48  # over-capacity on odd frames (clamped)
    desc = rng.integers(0, 2**32, size=(n_kp, 8), dtype=np.uint32)
    xy = rng.uniform(0, 100, size=(n_kp, 2)).astype(np.float32)
    slots.append(
        m.add_frame(float(i), rng.normal(0, 0.1, 6), xy,
                    np.zeros(n_kp, np.int32), np.ones(n_kp, np.float32), desc,
                    gt_pose44=np.eye(4))
    )
    m.set_keyframe(slots[-1])
pts = []
for j in range(64):
    pt = m.add_point(rng.normal(0, 1, 3).astype(np.float32),
                     desc=rng.integers(0, 2**32, size=8, dtype=np.uint32),
                     first_kf=j % 4)
    pts.append(pt)
    for s in slots[: 2 + j % 4]:
        m.add_observation(pt, s, j % 32)
# boundary abuse: invalid ids everywhere
m.add_observation(-1, 0, 0); m.add_observation(9999, 0, 0)
m.add_observation(pts[0], -3, 0); m.add_observation(pts[0], 0, 9999)
m.remove_observation(-1, 0); m.set_outlier(0, 31, True); m.set_outlier(-1, -1, True)
for s in slots:
    m.update_covisibility(s)
    m.best_covisible(s, 10)
m.fuse_points(pts[0], pts[1]); m.fuse_points(pts[2], pts[2]); m.fuse_points(-1, pts[3])
m.refresh_point_descriptors(pts + [-1, 100000])
m.refresh_frame_points(slots[0]); m.refresh_frame_points(-1)
dirs = m.point_view_dirs(pts + [-1, 100000])
assert dirs.shape == (len(pts) + 2, 3)
m.point_obs_counts(np.array(pts + [-1, 99999], np.int32))
m.point_observations(pts[4], cap=2)  # cap smaller than obs count
m.cull_recent_points(4, 4, 3)
m.cull_redundant_keyframes()
m.window_closure(slots[:3], obs_cap=2, pt_cap=4)  # undersized caps
kfs = m.active_keyframes()
if len(kfs) >= 2:
    m.snapshot_problem(kfs.tolist(), min_obs=2)
m.erase_frame(slots[1]); m.erase_frame(slots[1])
m.erase_point(pts[5]); m.erase_point(pts[5])
print("ASAN-EXERCISE-OK")
"""


@pytest.mark.skipif(sys.platform != "linux", reason="ASan preload is linux-only")
def test_mapstore_under_asan():
    subprocess.run(["make", "-s", "-C", NATIVE_DIR, "debug"], check=True)
    libasan = subprocess.run(
        ["g++", "-print-file-name=libasan.so"], capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    libubsan = subprocess.run(
        ["g++", "-print-file-name=libubsan.so"], capture_output=True, text=True,
        check=True,
    ).stdout.strip()
    env = dict(os.environ)
    env["LD_PRELOAD"] = f"{libasan} {libubsan}"
    # python itself leaks by design; halt_on_error catches real UB/overflows
    env["ASAN_OPTIONS"] = "detect_leaks=0,abort_on_error=1"
    env["UBSAN_OPTIONS"] = "halt_on_error=1,abort_on_error=1"
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run(
        [sys.executable, "-c", EXERCISE], env=env, cwd=repo_root,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "ASAN-EXERCISE-OK" in out.stdout

"""Command-line entry point, mirroring the reference CLI.

Reference: `ba_project/src/main.cpp:27-44` flags with defaults at
`main.cpp:48-64`, output-name mangling at `:175-184`, optional
reconstruction error at `:189-202`.

Usage:
    python -m bundleadjustment_tpu.cli \
        --dataset-name freiburg_xyz --dataset-path /data/fr1_xyz \
        --init-type gtdepth --estimation ba --frames 50 \
        --output-path ./out --trajectory
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="bundleadjustment_tpu",
        description="SfM / bundle adjustment pipeline (JAX)",
    )
    p.add_argument("--init-type", choices=["standard", "gtdepth"], default="gtdepth")
    p.add_argument(
        "--estimation",
        choices=["pnp", "ba", "essential_or_homography"],
        default="ba",
    )
    p.add_argument(
        "--faces-type", choices=["standard", "poisson", "greedy"], default="standard"
    )
    p.add_argument(
        "--dataset-name",
        choices=["freiburg_xyz", "freiburg_teddy", "replica", "tum", "synthetic"],
        default="replica",
    )
    p.add_argument("--dataset-path", default="")
    p.add_argument("--output-path", default="./out")
    p.add_argument("--local-ba", action="store_true", default=False)
    p.add_argument("--frames", type=int, default=2000)
    p.add_argument("--reconstruction-error", default="", metavar="GT_PLY",
                   help="path to a GT point cloud / mesh PLY to compute the "
                        "ICP reconstruction error against")
    p.add_argument("--trajectory", action="store_true", default=False)
    p.add_argument("--display-pointcloud", action="store_true", default=False,
                   help="write the live point cloud PLY (no GUI viewer here)")
    p.add_argument("--cull-frames", action="store_true", default=False)
    # framework knobs
    p.add_argument("--n-features", type=int, default=1000)
    p.add_argument("--n-levels", type=int, default=8)
    p.add_argument("--ba-solver", choices=["dense", "pcg"], default="dense")
    p.add_argument("--no-fused-tracking", action="store_true", default=False,
                   help="run detect/match/BA as separate dispatches")
    p.add_argument("--no-warmup", action="store_true", default=False,
                   help="skip the background compile warm-up that pre-seeds "
                        "the pipeline's jit shape buckets")
    p.add_argument("--track-batch", type=int, default=8,
                   help="device-resident tracking microbatch size: this many "
                        "consecutive tracked frames run as one dispatch "
                        "(<=1 disables)")
    p.add_argument("--ba-layout", choices=["auto", "flat", "dense_landmark"],
                   default="auto",
                   help="BA data layout: auto (dense landmark-major above a "
                        "problem-size threshold), flat observation table, or "
                        "the dense landmark-major layout")
    p.add_argument("--global-ba", choices=["single", "windowed", "sharded"],
                   default="single", dest="global_ba",
                   help="global-BA execution mode: single-device "
                        "LM/DENSE_SCHUR, keyframe-window sharding + pose-"
                        "graph stitch (shard_map over the device mesh), or "
                        "landmark-sharded dense Schur with psummed QQ^T "
                        "partials")
    p.add_argument("--depth-landmarks", action="store_true", default=False,
                   help="RGB-D landmark seeding: backproject landmark-free "
                        "keypoints through each keyframe's depth map "
                        "(builds ~10k-landmark maps; see PipelineConfig)")
    p.add_argument("--predetect", action="store_true", default=False,
                   help="run the data-parallel batched frontend over all "
                        "frames up front (frame axis sharded over all local "
                        "devices), then track with match+estimate only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true", default=False)
    return p


def output_prefix(args):
    """Encode the config into the output name (reference main.cpp:175-184)."""
    parts = [
        args.dataset_name,
        args.init_type,
        args.estimation,
        "localba" if args.local_ba else "globalba",
        f"f{args.frames}",
    ]
    if args.cull_frames:
        parts.append("cull")
    return "_".join(parts)


def load_dataset(args):
    from bundleadjustment_tpu.data.replica import ReplicaDataset
    from bundleadjustment_tpu.data.tum import TUMDataset

    if args.dataset_name in ("freiburg_xyz", "freiburg_teddy", "tum", "synthetic"):
        ds = TUMDataset(root=args.dataset_path, max_frames=args.frames)
        # synthetic datasets carry their intrinsics in a sidecar file
        sidecar = os.path.join(args.dataset_path, "intrinsics.json")
        if os.path.exists(sidecar):
            import numpy as np

            with open(sidecar) as f:
                k = json.load(f)
            ds.K4 = np.array([k["fx"], k["fy"], k["cx"], k["cy"]], np.float32)
            ds.width, ds.height = k["width"], k["height"]
        return ds
    elif args.dataset_name == "replica":
        return ReplicaDataset(root=args.dataset_path, max_frames=args.frames)
    raise ValueError(args.dataset_name)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from bundleadjustment_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from bundleadjustment_tpu.data.tum import write_tum_trajectory
    from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline, PipelineConfig
    from bundleadjustment_tpu.vis.mesh import create_map_mesh, write_off, write_ply

    ds = load_dataset(args)
    cfg = PipelineConfig(
        init_type=args.init_type,
        estimation=args.estimation,
        faces_type=args.faces_type,
        dataset_name=args.dataset_name,
        dataset_path=args.dataset_path,
        output_path=args.output_path,
        local_ba=args.local_ba,
        max_frames=args.frames,
        cull_frames=args.cull_frames,
        n_features=args.n_features,
        n_levels=args.n_levels,
        ba_solver=args.ba_solver,
        ba_layout=args.ba_layout,
        global_ba_mode=args.global_ba,
        depth_landmarks=args.depth_landmarks,
        fused_tracking=not args.no_fused_tracking,
        track_batch=args.track_batch,
        seed=args.seed,
        verbose=args.verbose,
    )
    pipe = BundleAdjustmentPipeline(cfg, ds.K4, ds.width, ds.height)
    if not args.no_warmup:
        # pre-seed the jit shape buckets on background threads: every
        # first-touch bucket otherwise stalls the frame loop on its compile
        from bundleadjustment_tpu.pipeline.warmup import CompileWarmer

        CompileWarmer(pipe).start()

    os.makedirs(args.output_path, exist_ok=True)
    prefix = os.path.join(args.output_path, output_prefix(args))

    viz = None
    if args.display_pointcloud:
        from bundleadjustment_tpu.vis.live import LiveVisualizer

        viz = LiveVisualizer(pipe, args.output_path, interval_s=1.0)

    mesh = None
    if args.predetect:
        import jax
        import numpy as np_

        from bundleadjustment_tpu.parallel.frontend import FRAME_AXIS

        devs = jax.devices()
        if len(devs) > 1:
            from jax.sharding import Mesh

            mesh = Mesh(np_.array(devs), (FRAME_AXIS,))
    stats = pipe.run(ds, predetect=args.predetect, mesh=mesh)
    if viz is not None:
        viz.close()

    ts, mats = pipe.trajectory_cam_to_world()
    if args.trajectory:
        write_tum_trajectory(prefix + "_estimatedPoses.txt", ts, mats)

    pts, pt_colors = pipe.map_points_colored()
    kf_slots = pipe.map.active_keyframes()
    import numpy as np

    from bundleadjustment_tpu.geometry import np_se3

    cam_mats = [
        np_se3.rt6_to_mat44(np_se3.rt6_inverse(pipe.map.kf_pose[k])) for k in kf_slots
    ]
    verts, faces, colors = create_map_mesh(
        pts, colors=pt_colors, cam_poses=cam_mats, faces_type=args.faces_type
    )
    write_off(prefix + "_mesh.off", verts, faces, colors)
    if args.display_pointcloud:
        write_ply(prefix + "_cloud.ply", pts, colors=pt_colors)

    results = dict(stats)
    results["n_map_points"] = int(len(pts))
    results["n_keyframes_final"] = int(len(kf_slots))

    # ATE against dataset ground truth when available
    gt = [(f.timestamp, f.gt_cam_to_world) for f in ds if f.gt_cam_to_world is not None]
    if len(gt) >= 2 and len(ts) >= 2:
        from bundleadjustment_tpu.metrics import evaluate_ate

        gt_ts = np.array([t for t, _ in gt])
        gt_xyz = np.array([M[:3, 3] for _, M in gt])
        try:
            ate = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz, max_difference=0.05)
            results["ate_rmse"] = ate["rmse"]
            results["ate_scale"] = ate["scale"]
        except ValueError:
            pass

    if args.reconstruction_error:
        from bundleadjustment_tpu.metrics import reconstruction_error
        from bundleadjustment_tpu.vis.mesh import read_ply_vertices

        gt_cloud = read_ply_vertices(args.reconstruction_error)
        first_kf = int(kf_slots[0]) if len(kf_slots) else 0
        err, _ = reconstruction_error(
            pts, gt_cloud, first_kf_gt_pose=pipe.map.kf_gt[first_kf],
            out_prefix=prefix,  # comparison PLYs (ReconstructionError.cpp:106-107,174)
        )
        results["reconstruction_error"] = err

    with open(prefix + "_results.json", "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])

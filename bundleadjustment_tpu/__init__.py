"""bundleadjustment_tpu — a Structure-from-Motion / SLAM engine in JAX.

Built from scratch in JAX/XLA (jit + shard_map distribution) with the
capability surface of the reference C++ pipeline
``MatteoWohlrapp/BundleAdjustment`` (OpenCV + Ceres + PCL), re-designed for
an accelerator:

- dense SoA scene state (poses / landmarks / observation table + masks) instead of
  a pointer graph (`ba_project/src/model/*` in the reference),
- batched feature detection + descriptor matching kernels instead of
  SURF/FLANN (`ba_project/src/ba/FeatureProcessor.cpp`),
- an analytic-Jacobian Levenberg-Marquardt engine with Schur-complement
  camera reduction (dense or matrix-free PCG) instead of Ceres
  (`ba_project/src/ba/Optimizer.cpp`),
- vectorized RANSAC two-view geometry instead of cv::findEssentialMat /
  findHomography (`ba_project/src/ba/SfMHelper.cpp:498-742`),
- multi-device sharding of the Schur reduction via shard_map + psum collectives.
"""

__version__ = "0.1.0"

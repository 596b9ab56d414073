"""The port's user scripts, one module each, the twins of the JAX
package's scripts/ of the same names, with the same arguments and printed
lines and a --device argument (default cuda; raises without a GPU):

  python -m xrsfm_tpu_torch.tools.synth_dataset <out> [--scene arc|loop|corridor]
  python -m xrsfm_tpu_torch.tools.synth_features <out> [--scene kitti|unordered|tour]
  python -m xrsfm_tpu_torch.tools.run_test_data <workspace> [--correct_pose]
  python -m xrsfm_tpu_torch.tools.evaluate_model <model_dir> <gt_poses.txt>
  python -m xrsfm_tpu_torch.tools.pointcloud_color --image_dir D --bin_dir M
  python -m xrsfm_tpu_torch.tools.run_kitti <kitti_root> <workspace>
  python -m xrsfm_tpu_torch.tools.run_1dsfm <data_root> <workspace>

and the measurement scripts, each printing one JSON line:

  python -m xrsfm_tpu_torch.tools.bench                (the repo's bench.py)
  python -m xrsfm_tpu_torch.tools.e2e_bench [--steady] [--count_dispatches]
  python -m xrsfm_tpu_torch.tools.run_unordered_bench [--scene tour]
  python -m xrsfm_tpu_torch.tools.profile_sift
  python -m xrsfm_tpu_torch.tools.profile_ba
  python -m xrsfm_tpu_torch.tools.dist_scaling
  python -m xrsfm_tpu_torch.tools.dist_multiprocess [--procs 2]
"""

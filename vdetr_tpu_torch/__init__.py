"""vdetr_tpu_torch: V-DETR in PyTorch on an NVIDIA H100: the eval forward
(`models.vdetr.build_model`), the eval step with its NMS and the VoteNet
AP (`train.engine.Trainer.eval_step`, `eval/`), the train step
(`train.engine.Trainer`) of the published model, and the CLI that
trains, checkpoints, resumes and evaluates it on ScanNet-format scans
(`python -m vdetr_tpu_torch.main`).

A port of `vdetr_tpu` (JAX on a TPU), which stays in the repository as
the reference. Module names mirror `vdetr_tpu/` so each counterpart is
easy to find. The Pallas kernels on these paths become CUDA C++ kernels
for Hopper (`csrc/`), each with a plain PyTorch version in the module
that wraps it: a wrapper launches its kernel on CUDA tensors and takes
the plain version only for tensors on the CPU. Entry points put the
model on the CUDA card unless the caller passes `device`.

The package imports torch and numpy, and nothing of `vdetr_tpu`: what it
shares with it (the configuration, the weight-name mapping) it keeps in
its own copies (`config.py`, `convert.py`, the numpy AP in `eval/`).
"""

__version__ = "0.2.0"

"""PyTorch + CUDA port of `wsi_hgnn_tpu` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout and names module by module,
so each file here has its counterpart there (`ops/knn.py` <->
`wsi_hgnn_tpu/ops/knn.py`, ...). It imports `torch` and never JAX, Flax
or anything of `wsi_hgnn_tpu`; weights cross the boundary as flax-layout
nested dicts of numpy arrays (`convert.py`).

Every Pallas kernel of the JAX package has a hand-written CUDA C++
counterpart under `csrc/`, built with `nvcc` for `sm_90a` at first use
(`kernels/_build.py`) and bound through `ctypes`. Each kernel wrapper in
`kernels/` runs its plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no card and no explicit CPU request they raise.
"""

__all__ = ["convert", "kernels", "models", "ops", "serve", "utils"]

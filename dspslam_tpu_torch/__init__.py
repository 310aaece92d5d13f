"""dspslam_tpu_torch: the PyTorch + CUDA port of dspslam_tpu.

Mirrors the JAX package's layout module by module. Plain tensor code is
PyTorch; the TPU's Pallas kernels become hand-written CUDA kernels for
Hopper (`csrc/`, bound in `kernels/`), each with a plain PyTorch version
that CPU tensors take. Entry points turn TF32 off in cuBLAS and cuDNN, so
geometry and the decoder run in full float32.
"""

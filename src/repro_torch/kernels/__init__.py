"""Hand-written Hopper kernels for the port's compute hot-spots.

Each kernel package holds ``csrc/*.cu`` (the CUDA C++ kernel for sm_90a,
with a plain C entry point), ``ops.py`` (the wrapper: checks, launch on the
current stream, a ``LAUNCHES`` count; tensors on the CPU go to the plain
version) and ``ref.py`` (the plain PyTorch version, the kernel's oracle).
``_build.py`` compiles the sources with nvcc at first use.

  adamw             AdamW with its global-norm clip over a float32 tree (training)
  flash_attention   blocked online-softmax attention (causal + GQA), forward
  quant_blockwise   blockwise int8 quantise / dequantise (the TCE int8 codec)
  ssd_scan          Mamba-2 SSD chunked scan (the SSM family's prefill)
"""

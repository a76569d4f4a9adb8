"""vampnet_tpu_torch — the PyTorch/CUDA port of `vampnet_tpu`.

The JAX package `vampnet_tpu` is the reference; every module here keeps the
name and place of its JAX counterpart so a reader can hold the two side by
side. Plain tensor code is PyTorch; each Pallas TPU kernel on the ported path
is a CUDA C++ kernel for Hopper (`csrc/`), built with `nvcc` at first use and
loaded with `ctypes` (`ops/build.py`).

Entry points run on the card unless the caller passes `device="cpu"`. On CPU
tensors every kernel wrapper takes its plain PyTorch version; on CUDA tensors
it launches the kernel or raises.

Layer map (mirrors `vampnet_tpu`):
  audio/     host-side signal substrate (WAV files, resample, loudness,
             padding, pitch shift)
  codec/     LAC codec: weight-norm conv encoder/decoder + RVQ
  mask.py    token mask algebra
  modules/   the masked-token transformer LM
  sampling/  MaskGIT sampling loop and token samplers
  ops/       attention dispatcher + the hand-written kernels' wrappers
  interface  `Interface`: `from_checkpoints`, `vamp_e2e` (one call), the
             staged API (`encode`, `build_mask`, `set_chunk_size`, `vamp`,
             `decode`) and `load_finetuned`/`reload`
  convert    flax-shaped param trees <-> port state dicts; upstream .pth
             checkpoints -> flax-shaped trees
  checkpoints  `.vtpu` files (shared with the JAX package) and `.pth` loads
  registry   the local models directory and the LoRA fine-tunes in it
  serve/     the continuous-batching engine, the stdlib web app, the app's
             `vamp_core` (and its Gradio UI), the unloop OSC bridge and the
             token telephone
  profiling  the tracer (spans at the engine, web request and training step
             boundaries), the unloop timer and `torch.profiler` traces
"""
__version__ = "0.1.0"

DEFAULT_MODEL = "default"
DEFAULT_HF_MODEL_REPO = "hugggof/vampnet"

"""dynamicvectorquantization_torch — the PyTorch + CUDA port of dqvq-tpu.

A second package beside `dynamicvectorquantization_tpu` (the JAX reference,
which it never imports). It keeps that package's subpackage names so each
module's counterpart is easy to find:

  config/   YAML loader + registry (reference target strings -> torch classes)
  nn/       LayerNorm, GELU, KV-cached transformer, StackGPT, conv blocks,
            position embeddings, positional decoder
  ops/      int8 KV decode attention and fused attention (CUDA kernels with
            plain-PyTorch versions), the VQ codebook
  models/   Dualformer sampling + decode, DQ-VAE decode half, permuter,
            label providers, sampling filters
  serve/    dynamic-batching sampler
  utils/    instantiation, weight conversion, model loading, devices
  csrc/     CUDA C++ sources of the kernels (built at first use by nvcc)

Parameter names follow the reference torch modules, so a reference stage-2
`.ckpt` state_dict loads with `load_state_dict`.
"""

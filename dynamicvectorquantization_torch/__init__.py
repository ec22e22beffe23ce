"""dynamicvectorquantization_torch — the PyTorch + CUDA port of dqvq-tpu.

A second package beside `dynamicvectorquantization_tpu` (the JAX reference,
which it never imports). It keeps that package's subpackage names so each
module's counterpart is easy to find:

  config/   YAML loader + registry (reference target strings -> torch classes)
  nn/       LayerNorm, GELU, transformer blocks (training and KV-cached
            decode), StackGPT, conv blocks, routers, dual-grain encoder,
            position embeddings, positional decoder
  ops/      the CUDA kernels' wrappers, each beside its plain-PyTorch version:
            int8 KV decode attention, fused attention forward and backward,
            LayerNorm forward and backward, fused AdamW, patch entropy,
            strided downsample, nearest codes
  models/   Dualformer (encode, training forward, sampling, decode) and the
            class-conditional ClassCondDualformer, DQ-VAE, permuter, label
            providers (SOS, class-aware), sampling filters
  train/    LR schedules, both trainers, the epoch loop and its command line
            (`python -m dynamicvectorquantization_torch.train`)
  sample/   sampling entry points: pickled batches and grids for FID
            (`python -m dynamicvectorquantization_torch.sample.val`), one PNG
            per image (`...sample.images`)
  serve/    dynamic-batching sampler and its HTTP front end
            (`python -m dynamicvectorquantization_torch.serve`)
  utils/    instantiation, weight conversion, model loading, devices
  data/     datasets (ImageNet, FFHQ, CelebA-HQ, FacesHQ, synthetic), the
            image reader and Pillow-exact transforms, the prefetching loader
  native/   the host image pipeline's C++ (Pillow's resampler, PNG
            unfiltering, JPEG through libjpeg or the port's own decoder;
            built at first use by g++)
  tools/    offline tools: ImageNet preparation, entropy-threshold tables,
            grain-map overlays
  csrc/     CUDA C++ sources of the kernels (built at first use by nvcc)

Parameter names follow the reference torch modules, so a reference stage-2
`.ckpt` state_dict loads with `load_state_dict`.
"""

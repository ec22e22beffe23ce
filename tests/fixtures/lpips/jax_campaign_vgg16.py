"""Writes the seeded LPIPS VGG16 backbone of the JAX package's stage-1
campaign runs (r04 / r05: `train.py --seed 23` on
`configs/stage1/dqvae-entropy-dual-r05_imagenet.yml`) as a torchvision
`vgg16` state dict, so that the port's stage 1 can train with the very same
random features (`DQVQ_LPIPS_VGG`; `tools/stage1_causes.py --legs lpips_jax`).

    JAX_PLATFORMS=cpu python tests/fixtures/lpips/jax_campaign_vgg16.py <out.pt>

The JAX loop initialises stage 1 with `Stage1Trainer.init_state(PRNGKey(seed),
x0[:1])`, which draws the loss's parameters (LPIPS backbone included) as
`loss.init({"params": fold_in(rng, 7)}, x, x, train=False)`; the draw depends
on the key and the shapes only. Needs the JAX package (about 14.7 M
parameters, ~59 MB written).
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
YML = "configs/stage1/dqvae-entropy-dual-r05_imagenet.yml"
SEED = 23
# torchvision vgg16().features indices of the 13 convs (conv_0 .. conv_12)
FEATURE_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def main(out):
    sys.path.insert(0, REPO)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import torch

    import dynamicvectorquantization_tpu.nn.lpips  # noqa: F401  (constants before tracing)
    from dynamicvectorquantization_tpu.config.yaml_config import load_config
    from dynamicvectorquantization_tpu.utils.instantiate import instantiate_from_config

    jax.config.update("jax_platforms", "cpu")
    cfg = load_config([os.path.join(REPO, YML)])["model"]
    model = instantiate_from_config(cfg)
    size = cfg["params"]["encoderconfig"]["params"]["resolution"]
    x = jnp.zeros((1, size, size, 3))
    loss_vars = jax.jit(lambda r: model.loss.init({"params": r}, x, x, train=False))(
        jax.random.fold_in(jax.random.PRNGKey(SEED), 7))
    net = jax.device_get(loss_vars)["params"]["perceptual_loss"]["net"]
    sd = {}
    for i, idx in enumerate(FEATURE_INDEX):
        conv = net[f"conv_{i}"]
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1))))
        sd[f"features.{idx}.bias"] = torch.from_numpy(np.asarray(conv["bias"]).copy())
    torch.save(sd, out)
    print(f"{out}: {sum(v.numel() for v in sd.values())} parameters")


if __name__ == "__main__":
    main(sys.argv[1])

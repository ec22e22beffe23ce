"""Offline tools as entry points of the port (counterparts of the JAX
package's `scripts/tools/`):

  python -m dynamicvectorquantization_torch.tools.prepare_imagenet --root <dir>
  python -m dynamicvectorquantization_torch.tools.calculate_entropy_thresholds --dataset imagenet
  python -m dynamicvectorquantization_torch.tools.visualize_dual_grain --yaml_path <stage-1 yml>
  python -m dynamicvectorquantization_torch.tools.campaign_product --out <dir> [--skip_data]
  python -m dynamicvectorquantization_torch.tools.convergence_campaign {stage1,stage2,finalize}
  python -m dynamicvectorquantization_torch.tools.orbax_to_pt <JAX checkpoints dir> --out <run dir>
"""

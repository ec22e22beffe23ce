"""Evaluation of the port (counterpart of `dynamicvectorquantization_tpu/eval/`
and of the JAX package's `scripts/tools/` evaluation scripts): FID and rFID
(`fid.py`, over the InceptionV3 trunk of `inception.py`), and the entry
points `python -m dynamicvectorquantization_torch.eval.<name>` for
`compute_fid`, `codebook_usage`, `codebook_pca` and `parity_report`.
"""

"""Training-quality smokes of the port:
`python -m mipnerf_pl_tpu_torch.tools.<name>`."""

"""Command-line tools of the port (`python -m mxnet_tpu_torch.tools.<name>`):
`im2rec`, which packs an image folder into RecordIO."""

"""Dataset converters into the nnU-Net raw layout (copies of
``mlagg_unet_tpu/dataset_conversion/``)."""

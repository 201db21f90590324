"""Global configuration knobs (reference: mlagg/nnunetv2/configuration.py:5-10).

Copied from ``mlagg_unet_tpu/configuration.py``: the knob the resampling
reads."""

# threshold (spacing_max / spacing_min) above which a dataset counts as
# anisotropic and gets the separate-z resampling path
ANISO_THRESHOLD = 3

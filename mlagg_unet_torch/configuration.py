"""Global configuration knobs (reference: mlagg/nnunetv2/configuration.py:5-10).

Copied from ``mlagg_unet_tpu/configuration.py``."""
import os

default_num_processes = int(os.environ.get("MLAGG_def_n_proc", 8))

# threshold (spacing_max / spacing_min) above which a dataset counts as
# anisotropic and gets the separate-z resampling path
ANISO_THRESHOLD = 3

default_n_proc_DA = int(os.environ.get("MLAGG_n_proc_DA", 4))

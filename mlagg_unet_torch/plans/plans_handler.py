"""Plans / configuration managers.

Byte-compatible views over the reference's ``nnUNetPlans.json`` contract
(reference: mlagg/nnunetv2/utilities/plans_handling/plans_handler.py:30,178),
including ``inherits_from`` configuration inheritance with cycle detection
(:195-217). Torch-class reflection (UNet_class, preprocessor_class, resampling
fn resolution) is replaced by string identifiers resolved through registries —
declarative configs instead of trainer-subclass-as-config.
"""
from __future__ import annotations

from copy import deepcopy
from functools import lru_cache, partial
from typing import Any, Dict, List, Tuple, Union

from mlagg_unet_torch.utils.helpers import load_json
from mlagg_unet_torch.plans.label_handling import LabelManager


class ConfigurationManager:
    def __init__(self, configuration_dict: dict):
        self.configuration = configuration_dict

    def __repr__(self):
        return self.configuration.__repr__()

    @property
    def data_identifier(self) -> str:
        return self.configuration["data_identifier"]

    @property
    def preprocessor_name(self) -> str:
        return self.configuration["preprocessor_name"]

    @property
    def batch_size(self) -> int:
        return self.configuration["batch_size"]

    @property
    def patch_size(self) -> List[int]:
        return self.configuration["patch_size"]

    @property
    def median_image_size_in_voxels(self) -> List[int]:
        return self.configuration["median_image_size_in_voxels"]

    @property
    def spacing(self) -> List[float]:
        return self.configuration["spacing"]

    @property
    def normalization_schemes(self) -> List[str]:
        return self.configuration["normalization_schemes"]

    @property
    def use_mask_for_norm(self) -> List[bool]:
        return self.configuration["use_mask_for_norm"]

    @property
    def UNet_class_name(self) -> str:
        return self.configuration["UNet_class_name"]

    @property
    def UNet_base_num_features(self) -> int:
        return self.configuration["UNet_base_num_features"]

    @property
    def n_conv_per_stage_encoder(self) -> List[int]:
        return self.configuration["n_conv_per_stage_encoder"]

    @property
    def n_conv_per_stage_decoder(self) -> List[int]:
        return self.configuration["n_conv_per_stage_decoder"]

    @property
    def num_pool_per_axis(self) -> List[int]:
        return self.configuration["num_pool_per_axis"]

    @property
    def pool_op_kernel_sizes(self) -> List[List[int]]:
        return self.configuration["pool_op_kernel_sizes"]

    @property
    def conv_kernel_sizes(self) -> List[List[int]]:
        return self.configuration["conv_kernel_sizes"]

    @property
    def unet_max_num_features(self) -> int:
        return self.configuration["unet_max_num_features"]

    @property
    def resampling_fn_data_name(self) -> str:
        return self.configuration["resampling_fn_data"]

    @property
    def resampling_fn_data(self):
        from mlagg_unet_torch.preprocessing import resampling

        fn = getattr(resampling, self.configuration["resampling_fn_data"])
        return partial(fn, **self.configuration["resampling_fn_data_kwargs"])

    @property
    def resampling_fn_probabilities(self):
        from mlagg_unet_torch.preprocessing import resampling

        fn = getattr(resampling, self.configuration["resampling_fn_probabilities"])
        return partial(fn, **self.configuration["resampling_fn_probabilities_kwargs"])

    @property
    def resampling_fn_seg(self):
        from mlagg_unet_torch.preprocessing import resampling

        fn = getattr(resampling, self.configuration["resampling_fn_seg"])
        return partial(fn, **self.configuration["resampling_fn_seg_kwargs"])

    @property
    def batch_dice(self) -> bool:
        return self.configuration["batch_dice"]

    @property
    def next_stage_names(self) -> Union[List[str], None]:
        ret = self.configuration.get("next_stage")
        if ret is not None and isinstance(ret, str):
            ret = [ret]
        return ret

    @property
    def previous_stage_name(self) -> Union[str, None]:
        return self.configuration.get("previous_stage")


class PlansManager:
    """Lazy view over plans.json with configuration-inheritance resolution."""

    def __init__(self, plans_file_or_dict: Union[str, dict]):
        self.plans = (
            plans_file_or_dict
            if isinstance(plans_file_or_dict, dict)
            else load_json(plans_file_or_dict)
        )

    def __repr__(self):
        return self.plans.__repr__()

    def _internal_resolve_configuration_inheritance(
        self, configuration_name: str, visited: Tuple[str, ...] = None
    ) -> dict:
        if configuration_name not in self.plans["configurations"]:
            raise ValueError(
                f"Requested configuration {configuration_name} not found in plans. "
                f"Available: {list(self.plans['configurations'].keys())}"
            )
        configuration = deepcopy(self.plans["configurations"][configuration_name])
        if "inherits_from" in configuration:
            parent_name = configuration["inherits_from"]
            if visited is None:
                visited = (configuration_name,)
            else:
                if parent_name in visited:
                    raise RuntimeError(
                        f"Circular dependency detected: configs {visited} inherit from "
                        f"each other. Cannot resolve {configuration_name}."
                    )
                visited = (*visited, configuration_name)
            base = self._internal_resolve_configuration_inheritance(parent_name, visited)
            base.update(configuration)
            configuration = base
        return configuration

    @lru_cache(maxsize=10)
    def get_configuration(self, configuration_name: str) -> ConfigurationManager:
        configuration_dict = self._internal_resolve_configuration_inheritance(
            configuration_name
        )
        return ConfigurationManager(configuration_dict)

    @property
    def dataset_name(self) -> str:
        return self.plans["dataset_name"]

    @property
    def plans_name(self) -> str:
        return self.plans["plans_name"]

    @property
    def original_median_spacing_after_transp(self) -> List[float]:
        return self.plans["original_median_spacing_after_transp"]

    @property
    def original_median_shape_after_transp(self) -> List[float]:
        return self.plans["original_median_shape_after_transp"]

    @property
    def image_reader_writer_name(self) -> str:
        return self.plans["image_reader_writer"]

    @property
    def image_reader_writer_class(self):
        from mlagg_unet_torch.imageio.reader_writer_registry import (
            recursive_find_reader_writer_by_name,
        )

        return recursive_find_reader_writer_by_name(self.image_reader_writer_name)

    @property
    def transpose_forward(self) -> List[int]:
        return self.plans["transpose_forward"]

    @property
    def transpose_backward(self) -> List[int]:
        return self.plans["transpose_backward"]

    @property
    def available_configurations(self) -> List[str]:
        return list(self.plans["configurations"].keys())

    @property
    def experiment_planner_name(self) -> str:
        return self.plans["experiment_planner_used"]

    def get_label_manager(self, dataset_json: dict, **kwargs) -> LabelManager:
        return LabelManager(
            label_dict=dataset_json["labels"],
            regions_class_order=dataset_json.get("regions_class_order"),
            **kwargs,
        )

    @property
    def foreground_intensity_properties_per_channel(self) -> dict:
        if "foreground_intensity_properties_per_channel" not in self.plans:
            if "foreground_intensity_properties_by_modality" in self.plans:
                return self.plans["foreground_intensity_properties_by_modality"]
        return self.plans["foreground_intensity_properties_per_channel"]

"""Reader/writer selection (reference: imageio/reader_writer_registry.py:23-70).

File-ending based selection with the dataset.json
``overwrite_image_reader_writer`` escape hatch. SimpleITKIO/NibabelIO names
map onto our pure-NumPy NIfTI implementation so reference-generated
plans/dataset jsons keep working.
"""
from __future__ import annotations

from typing import Optional, Type

from mlagg_unet_torch.imageio.base_reader_writer import BaseReaderWriter
from mlagg_unet_torch.imageio.natural_image_io import NaturalImage2DIO
from mlagg_unet_torch.imageio.nifti_io import (
    NibabelIO,
    NibabelIOWithReorient,
    NiftiIO,
    SimpleITKIO,
)
from mlagg_unet_torch.imageio.gipl_io import GiplIO
from mlagg_unet_torch.imageio.metaimage_io import MetaImageIO
from mlagg_unet_torch.imageio.nrrd_io import NrrdIO
from mlagg_unet_torch.imageio.numpy_io import NumpyIO
from mlagg_unet_torch.imageio.tiff_io import Tiff3DIO

# Tiff3DIO precedes NaturalImage2DIO so bare .tif resolves to the 3D reader
# (the reference's main tif use-case, Dataset073); 2D tif datasets select
# NaturalImage2DIO via overwrite_image_reader_writer in dataset.json.
LIST_OF_IO_CLASSES = [NiftiIO, SimpleITKIO, NibabelIO, NibabelIOWithReorient,
                      MetaImageIO, NrrdIO, GiplIO, Tiff3DIO,
                      NaturalImage2DIO, NumpyIO]

_BY_NAME = {cls.__name__: cls for cls in LIST_OF_IO_CLASSES}


def recursive_find_reader_writer_by_name(name: str) -> Type[BaseReaderWriter]:
    if name in _BY_NAME:
        return _BY_NAME[name]
    raise RuntimeError(f"Unknown reader/writer: {name}. Known: {list(_BY_NAME)}")


def determine_reader_writer_from_dataset_json(
    dataset_json: dict, example_file: Optional[str] = None
) -> Type[BaseReaderWriter]:
    if dataset_json.get("overwrite_image_reader_writer") is not None:
        return recursive_find_reader_writer_by_name(
            dataset_json["overwrite_image_reader_writer"]
        )
    file_ending = dataset_json["file_ending"]
    return determine_reader_writer_from_file_ending(file_ending)


def determine_reader_writer_from_file_ending(file_ending: str
                                             ) -> Type[BaseReaderWriter]:
    for cls in LIST_OF_IO_CLASSES:
        if any(file_ending.endswith(e) or e.endswith(file_ending)
               for e in cls.supported_file_endings):
            return cls
    raise RuntimeError(f"No reader/writer supports file ending {file_ending}")

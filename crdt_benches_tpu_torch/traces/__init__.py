from .loader import TRACES, TestData, TestPatch, TestTxn, load_testing_data, trace_path
from .tensorize import (
    RangeTrace,
    TensorizedTrace,
    coalesce_patches,
    explode_unit_ops,
    tensorize,
    tensorize_ranges,
)

__all__ = [
    "TRACES",
    "TestData",
    "TestPatch",
    "TestTxn",
    "load_testing_data",
    "trace_path",
    "RangeTrace",
    "coalesce_patches",
    "tensorize_ranges",
    "TensorizedTrace",
    "explode_unit_ops",
    "tensorize",
]

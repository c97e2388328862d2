from .loader import TRACES, TestData, TestPatch, TestTxn, load_testing_data, trace_path
from .tensorize import RangeTrace, coalesce_patches, tensorize_ranges

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
]

"""Analysis of sweep results: on-device top-k / Pareto reduction."""
from .pareto import (OBJECTIVES, ParetoFront, ReducedResult, Reduction, TopK,
                     fold_segments, make_device_reducer, merge_reduced,
                     reduce_on_device, reduce_oracle, reduced_nbytes,
                     remap_segments, spec_from_str, spec_to_str)

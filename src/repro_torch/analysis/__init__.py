"""Analysis of sweep results (on-device top-k / Pareto reduction) and
the roofline of the dry-run's records."""
from .roofline import (HW_H100, RooflineTerms, cell_roofline, model_flops,
                       load_dryrun_records, roofline_table)
from .pareto import (OBJECTIVES, ParetoFront, ReducedResult, Reduction, TopK,
                     fold_segments, make_device_reducer, merge_reduced,
                     reduce_on_device, reduce_oracle, reduced_nbytes,
                     remap_segments, spec_from_str, spec_to_str)

from .elastic import ElasticPlan, plan_downscale
from .faults import (FAULT_PLAN_ENV, BackendFault, FaultInjector, FaultPlan,
                     TransientFault)
from .heartbeat import FailureDetector, HeartbeatBus
from .straggler import StragglerDetector, StragglerPolicy

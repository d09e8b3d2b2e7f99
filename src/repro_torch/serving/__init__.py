from repro_torch.serving.engine import InferenceEngine, PagePoolExhausted  # noqa: F401
from repro_torch.serving.hibernation import HibernationStore  # noqa: F401
from repro_torch.serving.scheduler import QoSScheduler, Request, SchedulerStats  # noqa: F401
from repro_torch.serving.plane import (ServingPlane, PlaneResult, PlaneLoad,  # noqa: F401
                                       RealEngineBackend, SimulatedEngine)

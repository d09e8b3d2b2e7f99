"""NE-AIaaS core: the paper's contract layer (ASP, AIS, lifecycle procedures)."""

from repro_torch.core.asp import ASP, Objectives, Modality, InteractionMode, \
    MobilityClass, QualityTier, default_asp  # noqa: F401
from repro_torch.core.failures import FailureCause, SessionError, Timers, REMEDIATION  # noqa: F401
from repro_torch.core.session import AISession, SessionState, Binding  # noqa: F401
from repro_torch.core.orchestrator import Orchestrator, ServeResult  # noqa: F401

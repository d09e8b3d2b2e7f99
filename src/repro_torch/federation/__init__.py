"""Federated multi-domain control plane: east-west inter-domain API.

One :class:`~repro_torch.federation.domain.DomainController` per administrative
domain (operator); domains advertise coarse
:class:`~repro_torch.federation.registry.CapabilityDigest` records into a
:class:`~repro_torch.federation.registry.FederationRegistry` and speak the typed
:mod:`~repro_torch.federation.eastwest` protocol for DISCOVER solicitation,
cross-domain PREPARE/COMMIT/ABORT with SLA-budget decomposition, and
roaming make-before-break migration.
"""

from repro_torch.federation.domain import (DomainController, FederatedPrepared,
                                     GuestSiteView, RemoteModelRef)
from repro_torch.federation.eastwest import (EW_SCHEMA_VERSION, EWTimeout,
                                       SLABudget, apply_budget,
                                       decompose_budget)
from repro_torch.federation.registry import (CapabilityDigest, FederationRegistry,
                                       digest_of)

__all__ = [
    "DomainController", "FederatedPrepared", "GuestSiteView",
    "RemoteModelRef", "EW_SCHEMA_VERSION", "EWTimeout", "SLABudget",
    "apply_budget", "decompose_budget", "CapabilityDigest",
    "FederationRegistry", "digest_of",
]

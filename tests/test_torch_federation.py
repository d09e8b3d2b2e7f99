"""The port's copy of the federated control plane (``repro_torch.federation``)
over sites that run port engines, on the CPU: a session whose home domain
is saturated is established in the visited domain through the unchanged
northbound client, and the tokens it is served there are the tokens a
single-domain deployment of the same engine serves."""

import numpy as np

from repro_torch.api.client import SessionClient
from repro_torch.api.gateway import NorthboundGateway
from repro_torch.configs import get_config
from repro_torch.core.asp import QualityTier, default_asp
from repro_torch.core.catalog import Catalog, default_catalog
from repro_torch.core.clock import VirtualClock
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.sites import ExecutionSite, SiteSpec
from repro_torch.federation import DomainController, FederationRegistry
from repro_torch.models.transformer import LM
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.plane import RealEngineBackend, ServingPlane

MAX_LEN = 64
PARAMS = LM(get_config("edge-tiny")).init(0, "cpu")


def _orchestrator(clock, site_id: str, rtt: dict, slots: int):
    """One domain's orchestrator: a single edge-tiny site whose serving
    plane runs a port engine on the CPU."""
    cat = Catalog()
    cat.register(default_catalog().get("edge-tiny"))
    site = ExecutionSite(SiteSpec(
        site_id, "edge", "eu", chips=1, hbm_bytes_total=80e9,
        peak_flops=989e12, hbm_bw=3.35e12, decode_slots=slots,
        rtt_ms=dict(rtt), hosted_models=("edge-tiny@1.0",)), clock)
    eng = InferenceEngine(get_config("edge-tiny"), params=PARAMS, slots=2,
                          max_len=MAX_LEN, device="cpu")
    site.attach_engine(eng)
    site.attach_plane(ServingPlane(clock, RealEngineBackend(eng, clock),
                                   slots=2, site_id=site_id))
    return Orchestrator(clock=clock, catalog=cat, sites={site_id: site})


def _serve(gateway, prompt):
    asp = default_asp(tier=QualityTier.BASIC)
    with SessionClient(gateway, asp, invoker="ue", zone="zone-a") as c:
        tokens = c.generate(prompt_tokens=len(prompt), gen_tokens=6,
                            prompt=[int(t) for t in prompt]).tokens()
        return c.anchor, tokens


def test_spilled_session_serves_the_single_domain_tokens():
    prompt = np.random.default_rng(4).integers(0, 512, size=11)
    clock = VirtualClock()
    registry = FederationRegistry(clock, max_age_s=30.0)
    home = DomainController("home", registry, orchestrator=_orchestrator(
        clock, "h-edge", {"zone-a": 2.0}, slots=8))
    visited = DomainController("visited", registry, orchestrator=_orchestrator(
        clock, "v-edge", {"zone-a": 25.0}, slots=32))
    home.connect(visited, transit_ms=5.0)
    h_edge = home.core.sites["h-edge"]
    lease = h_edge.prepare(home.core.catalog.get("edge-tiny"), slots=8,
                           cache_bytes=0.0, ttl_s=1e9)
    h_edge.confirm(lease.lease_id, lease_s=1e9)          # home saturated
    anchor, fed = _serve(NorthboundGateway(home), prompt)
    assert anchor == "visited/v-edge"
    assert visited.core.sites["v-edge"].slots_in_use() == 0   # released
    # the visited site's port engine served it; the home engine never ran
    assert visited.core.sites["v-edge"].engine.prefill_compiles == 1
    assert h_edge.engine.prefill_compiles == 0

    single = _orchestrator(VirtualClock(), "s-edge", {"zone-a": 2.0}, 8)
    anchor, alone = _serve(NorthboundGateway(single), prompt)
    assert anchor == "s-edge"
    assert len(fed) == 6 and fed == alone

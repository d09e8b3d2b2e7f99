from repro_torch.sim.latency import LatencyModel, SimConfig  # noqa: F401
from repro_torch.sim.scenarios import (simulate_endpoint, simulate_neaiaas,  # noqa: F401
                                 simulate_multiclass, simulate_bursty,
                                 simulate_load_mobility,
                                 simulate_migration_under_load,
                                 simulate_payload_asymmetry,
                                 simulate_federated_roaming,
                                 simulate_home_overload_spillover)
from repro_torch.sim.mobility import simulate_mobility  # noqa: F401

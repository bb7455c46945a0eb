"""Scripted chaos drivers (beyond the reference, whose fault story is
manual process kills).  ``churn`` turns the PR 2 crash tooling + the
graceful preemption drain into a seeded, repeatable spot-churn engine
for elasticity soaks (docs/deployment.md "Elasticity & preemption")."""

from geomx_tpu_torch.chaos.churn import (ChurnOrchestrator, ChurnPhase,
                                   ChurnPlan)
from geomx_tpu_torch.chaos.netfault import (NetFaultOrchestrator,
                                      NetFaultPhase, NetFaultPlan,
                                      install_env_netfaults)

__all__ = ["ChurnOrchestrator", "ChurnPhase", "ChurnPlan",
           "NetFaultOrchestrator", "NetFaultPhase", "NetFaultPlan",
           "install_env_netfaults"]

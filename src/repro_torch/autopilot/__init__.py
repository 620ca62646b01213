"""Economics-in-the-loop autopilot: online reuse tracking (ghost cache +
decayed log-bucket sketch, one `reuse_sketch` kernel launch per batch on
the card), break-even admission for the tiered runtime, and a
provisioning advisor over one host's telemetry.
"""
from .advisor import (AvailabilityAdvice, ProvisionAdvice,
                      ProvisionAdvisor, TierAdvice)
from .gate import EconomicGate, GateStats, default_classify
from .reuse import ReuseTracker
from .traces import SCENARIOS, Trace, generate

__all__ = [
    "EconomicGate", "GateStats", "default_classify",
    "AvailabilityAdvice", "ProvisionAdvice", "ProvisionAdvisor",
    "TierAdvice",
    "ReuseTracker",
    "SCENARIOS", "Trace", "generate",
]

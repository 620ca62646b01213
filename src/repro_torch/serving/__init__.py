from .engine import DecodeEngine, Request, route_session  # noqa
from .scheduler import (  # noqa
    ContinuousScheduler, SessionJob, Turn, compare_scheduling,
    jobs_from_trace, run_lockstep)
from .tenants import run_tenant_bench, tenant_pack  # noqa

from .engine import DecodeEngine, Request, route_session  # noqa

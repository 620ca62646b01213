from .engine import DecodeEngine, Request  # noqa

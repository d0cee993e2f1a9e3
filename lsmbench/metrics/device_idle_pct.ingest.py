"""device_idle_pct.ingest, % (device trace): see ``lsmbench/device_idle.py``."""
from lsmbench.device_idle import read  # noqa: F401

"""The device's idle share in the detect cell's traced pass: the same
reading as ``device_idle_pct.calib``, split off because this cell reports
``detect_fps``."""

from benchmarks.harness import cell

read = cell.reader("device_idle_pct.calib")

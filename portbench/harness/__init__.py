"""The benchmark's general code: the frozen counts model, work counts and
peaks, the profiler reduction and the verdict that decides ``correct``.
What belongs to one traffic kind lives in ``kinds/<kind>.py``."""

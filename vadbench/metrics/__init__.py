"""Per-layer metric readers, one file per metric named as in BENCHMARK.json
(`<name>.py`, loaded by path), each `read(run) -> value or None`; and the
arithmetic they share (`counts`, `shared`)."""

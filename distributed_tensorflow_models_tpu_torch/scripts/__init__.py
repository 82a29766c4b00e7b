"""The fleet drills of the port: acceptance harnesses that drive it as a
real multi-process fleet.

- :mod:`serve_drill` — the file-queue serving fleet of
  ``serving/server.py`` replicas under ``launch.launch_local``: drain on
  SIGTERM, exactly-once answers, every stream equal to solo
  ``generate``; the speculative, SLO, disaggregated, overload,
  backpressure, autoscale and deploy arms;
- :mod:`fleet_drill` — two-process ``fit`` fleets on LeNet under
  cross-host chaos (visibility skew, a killed host, a straggler, a NaN
  rollback, elastic resize), each held bit for bit to a fault-free
  baseline.

Counterparts of the repository's ``scripts/serve_drill.py`` and
``scripts/fleet_drill.py``; run as ``python -m
distributed_tensorflow_models_tpu_torch.scripts.serve_drill`` (and
``.fleet_drill``).  They run on the card unless ``--device cpu`` is given.
The repository's report tools (``scripts/serving_report.py``,
``scripts/fleet_report.py``, ``scripts/check_metrics_schema.py``) read
their artifacts as subprocesses.
"""

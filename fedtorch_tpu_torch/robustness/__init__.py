"""In-round robustness (port of ``fedtorch_tpu/robustness``): the server's
update guards (``guards.py``) and the byzantine-robust aggregation rules
(``aggregators.py``). Chaos, availability and DP are not yet ported."""

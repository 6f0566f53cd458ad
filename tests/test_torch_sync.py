"""``core/sync.py``, port vs the JAX package: the per-epoch local-step
lists are bitwise equal for every warmup scheme and on/off gate."""
import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.core import sync as jsync
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.core import sync as tsync


@pytest.mark.parametrize("kw", [
    dict(num_epochs=10, local_step=4),
    dict(num_epochs=12, local_step=8, local_step_warmup_type="exp",
         local_step_warmup_period=6),
    dict(num_epochs=12, local_step=8, local_step_warmup_type="linear",
         local_step_warmup_period=5),
    dict(num_epochs=9, local_step=3, local_step_warmup_type="constant",
         local_step_warmup_period=4),
    dict(num_epochs=20, local_step=5, turn_on_local_step_from=10,
         lr_change_epochs="10,15"),
    dict(num_epochs=20, local_step=5, turn_off_local_step_from=15,
         lr_change_epochs="10,15"),
    dict(num_epochs=20, local_step=6, local_step_warmup_type="linear",
         local_step_warmup_period=3, warmup_per_intervals=True,
         lr_change_epochs="8,14"),
])
def test_define_sync_freq_is_the_jax_package_s(kw):
    assert tsync.define_sync_freq(**kw) == jsync.define_sync_freq(**kw)


def test_errors_and_config_entry_are_the_jax_package_s():
    for kw in (dict(local_step_warmup_type="cosine"),
               dict(warmup_per_intervals=True),
               dict(turn_on_local_step_from=1, turn_off_local_step_from=2,
                    lr_change_epochs="3")):
        with pytest.raises((NotImplementedError, ValueError)) as want:
            jsync.define_sync_freq(5, 2, **kw)
        with pytest.raises(type(want.value)):
            tsync.define_sync_freq(5, 2, **kw)

    def cfg(mod):
        return mod.ExperimentConfig(train=mod.TrainConfig(
            num_epochs=7, local_step=4, local_step_warmup_type="exp",
            local_step_warmup_period=4)).finalize()

    assert tsync.local_steps_from_config(cfg(tcfg)) == \
        jsync.local_steps_from_config(cfg(jcfg))

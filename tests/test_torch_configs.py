"""The port's configs equal the JAX package's, field by field."""
import dataclasses

import pytest

from repro import configs as jcfg
from repro_torch import configs as tcfg


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_registry_entry_matches_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jcfg, get)(arch)
        got = getattr(tcfg, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, get)
        assert got.num_params() == want.num_params()
        assert got.num_active_params() == want.num_active_params()
        for prop in ("q_dim", "kv_dim", "ssm_inner", "ssm_heads"):
            assert getattr(got, prop) == getattr(want, prop)


def test_registry_lists_and_shapes_match():
    assert tcfg.list_archs() == jcfg.list_archs()
    assert tcfg.ASSIGNED_ARCHS == jcfg.ASSIGNED_ARCHS
    assert tcfg.SKIPS == jcfg.SKIPS
    assert tcfg.dryrun_pairs() == jcfg.dryrun_pairs()
    assert ({k: dataclasses.asdict(v) for k, v in tcfg.INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jcfg.INPUT_SHAPES.items()})
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("no-such-arch")

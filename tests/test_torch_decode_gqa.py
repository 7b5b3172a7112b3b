"""The port's paged ``Decoder`` against the JAX package's on the
grouped-query rope LM (4 heads over 2 kv heads): the checks, models and
tolerances of ``test_torch_decode.py``, in a file of their own so that
each file stays short.
"""
import pytest

from test_torch_decode import CONFIGS, check_against_jax, models  # noqa: F401


@pytest.mark.parametrize("wd,mm,cache", CONFIGS,
                         ids=["-".join(filter(None, c)) for c in CONFIGS])
def test_gqa_rope_decoder_matches_jax(models, wd, mm, cache):  # noqa: F811
    check_against_jax(models, "gqa_rope", wd, mm, cache)

"""Port parity for the settings layer: the port's core/config is a copy of
the reference's, so the same raw values coerce, clamp and override to the
same settings, and the RD knobs resolve to the same RdConfig.
"""

import dataclasses

import pytest

from thinvids_tpu.codecs.h264 import rdo as jrdo
from thinvids_tpu.core import config as jcfg
from thinvids_tpu_torch.codecs.h264 import rdo as trdo
from thinvids_tpu_torch.core import config as tcfg

#: a spread of raw values as they arrive from the environment, the API's
#: JSON and per-job overrides
RAW = [None, True, False, 0, 1, -3, 7, 2.5, -0.25, 1e9, "", " ", "0",
       "1", "yes", "No", "off", "ON", "true", "27", " 33 ", "4.9", "-2",
       "1e3", "abc", "process", "thread", "remote", "vbr2pass", "720p",
       "1080,720;480p,bad,720", "Acme__x", "acme:3,bravo:1,bad:x",
       "drop;table"]


@pytest.fixture
def both_clean():
    """Both packages' settings stores without live overrides or a stale
    cache, before and after the test."""
    for cfg in (jcfg, tcfg):
        cfg.reset_live_settings()
    yield
    for cfg in (jcfg, tcfg):
        cfg.reset_live_settings()


def test_defaults_and_key_sets_match():
    assert tcfg.DEFAULT_SETTINGS == jcfg.DEFAULT_SETTINGS
    assert tcfg.JOB_SETTING_KEYS == jcfg.JOB_SETTING_KEYS
    assert set(tcfg._CLAMPS) == set(jcfg._CLAMPS)


@pytest.mark.parametrize("name", ["as_bool", "as_int", "as_float"])
def test_coercers_match(name):
    tf, jf = getattr(tcfg, name), getattr(jcfg, name)
    for raw in RAW:
        for default in (False, True, 0, 5, 0.0, 1.5):
            assert tf(raw, default) == jf(raw, default), (raw, default)


@pytest.mark.parametrize("key", sorted(jcfg.DEFAULT_SETTINGS))
def test_validate_setting_matches(key):
    for raw in RAW + [jcfg.DEFAULT_SETTINGS[key]]:
        assert tcfg._validate_setting(key, raw) == \
            jcfg._validate_setting(key, raw), raw


def test_env_overrides_match(monkeypatch, both_clean):
    env = {"TVT_QP": "33", "TVT_GOP_FRAMES": "12",
           "TVT_PACK_BACKEND": "process", "TVT_COMPACT_TRANSFER": "off",
           "TVT_PACK_WORKERS": "3", "TVT_PIPELINE_WINDOW": "junk",
           "TVT_DECODE_AHEAD": "5", "TVT_AQ_STRENGTH": "0.6",
           "TVT_SFE_BANDS": "2", "TVT_LADDER_RUNGS": "720,480"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tsnap = tcfg.get_settings(refresh=True)
    jsnap = jcfg.get_settings(refresh=True)
    assert dict(tsnap.values) == dict(jsnap.values)
    assert tsnap.qp == 33 and tsnap.compact_transfer is False
    # a junk int keeps the coercer's fallback, as in the reference
    assert tsnap.pipeline_window == jsnap.pipeline_window
    for k in env:
        monkeypatch.delenv(k)
    assert dict(tcfg.get_settings(refresh=True).values) == \
        dict(jcfg.get_settings(refresh=True).values)


def test_live_and_job_tiers_match(both_clean):
    updates = {"qp": "99", "pack_backend": "bogus", "ladder_rungs": "1080p,,x",
               "tenant": "Acme Corp", "tenant_shares": "a:2,b:0",
               "sfe_halo_rows": "40", "not_a_key": 1, "aq_strength": "9"}
    assert tcfg.update_live_settings(updates) == \
        jcfg.update_live_settings(updates)
    assert dict(tcfg.get_settings(refresh=True).values) == \
        dict(jcfg.get_settings(refresh=True).values)
    over = {"gop_frames": "0", "qp": "-4", "deblock": "yes",
            "execution_backend": "remote", "tenant": "B__"}
    tjob = tcfg.overlay_job_settings(tcfg.get_settings(), over)
    jjob = jcfg.overlay_job_settings(jcfg.get_settings(), over)
    assert dict(tjob.values) == dict(jjob.values)
    assert tjob.effective_max_active_jobs() == jjob.effective_max_active_jobs()


@pytest.mark.parametrize("over", [
    {}, {"mode_decision": "1"}, {"pskip": True, "deblock": "on"},
    {"aq_strength": "0.6"}, {"aq_strength": 7.0}, {"aq_strength": "x"},
    {"mode_decision": "maybe", "aq_strength": -1}])
def test_rd_from_settings_matches(over):
    values = dict(jcfg.DEFAULT_SETTINGS, **over)
    trd = trdo.rd_from_settings(tcfg.Settings(values=values))
    jrd = jrdo.rd_from_settings(jcfg.Settings(values=values))
    assert dataclasses.asdict(trd) == dataclasses.asdict(jrd)
    assert trd.ships_modes == jrd.ships_modes
    assert (trd == trdo.RD_OFF) == (jrd == jrdo.RD_OFF)


def test_aq_quantizer_matches():
    assert trdo.AQ_QUANT == jrdo.AQ_QUANT
    for s in (-1.0, 0.0, 0.12, 0.125, 0.5, 1.37, 2.9, 3.0, 8.0):
        assert trdo.aq_from_strength(s) == jrdo.aq_from_strength(s)

"""The port's roofline (``repro_torch.analysis.roofline``) against the JAX
package's (``repro.analysis.roofline``), which is pure Python over a
``ModelConfig`` and a ``ShapeConfig``.

For every arch of the registry at every shape cell (and the int8-cache
variant of the decode cells): ``analytic_hbm_bytes`` (single pod and
multi-pod, fp and int8 weights) and ``model_flops`` equal the reference's
to the bit; ``roofline_report``'s terms and derived properties equal the
reference's once the port's constants are set to ``HW_V5E``'s values
(each package then reckons on one chip). ``HW_H100`` holds the data
sheet's figures, and ``chip_smoke.py``'s peaks are read from it.
"""
import dataclasses
import pathlib

import numpy as np
import pytest

from repro.analysis import roofline as jax_roofline
from repro.configs import get_config as jax_get_config
from repro.models import SHAPES as JAX_SHAPES

from repro_torch.analysis import roofline
from repro_torch.configs import get_config, list_archs
from repro_torch.models import SHAPE_BY_NAME

ARCHS = list_archs()
SHAPE_NAMES = [s.name for s in JAX_SHAPES]


def _pair(arch, kv8=False):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if kv8:
        cfg = dataclasses.replace(cfg, kv_cache_bits=8)
        jcfg = dataclasses.replace(jcfg, kv_cache_bits=8)
    return cfg, jcfg


def test_the_registries_agree():
    """One arch list and one shape list in both packages."""
    from repro.configs import list_archs as jax_list_archs

    assert ARCHS == jax_list_archs()
    assert [(s.name, s.seq_len, s.global_batch, s.kind)
            for s in JAX_SHAPES] == [
        (s.name, s.seq_len, s.global_batch, s.kind)
        for s in SHAPE_BY_NAME.values()]


@pytest.mark.parametrize("shape_name", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_equal_the_reference(arch, shape_name):
    """``analytic_hbm_bytes`` at 256 and 512 chips, fp and int8 weights
    (and over the int8 cache at a decode cell), and ``model_flops``: the
    reference's floats, bit for bit."""
    shape = SHAPE_BY_NAME[shape_name]
    jshape = next(s for s in JAX_SHAPES if s.name == shape_name)
    for kv8 in ((False, True) if shape.kind == "decode" else (False,)):
        cfg, jcfg = _pair(arch, kv8)
        assert roofline.model_flops(cfg, shape) == \
            jax_roofline.model_flops(jcfg, jshape)
        for chips in (256, 512):
            for quantized in (False, True):
                got = roofline.analytic_hbm_bytes(cfg, shape, chips=chips,
                                                  quantized=quantized)
                want = jax_roofline.analytic_hbm_bytes(
                    jcfg, jshape, chips=chips, quantized=quantized)
                assert got == want, (kv8, chips, quantized)


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_report_equals_the_reference_at_its_constants(
        arch, monkeypatch):
    """With the port's constants set to ``HW_V5E``'s values (its link to
    the reference's ``ici_bw``), ``roofline_report`` gives the reference's
    terms and properties for every shape, from the same per-device counts
    (drawn from a seed)."""
    v5e = jax_roofline.HW_V5E
    monkeypatch.setattr(roofline, "HW_H100", {
        **roofline.HW_H100, "peak_flops_bf16": v5e["peak_flops_bf16"],
        "peak_flops_int8": v5e["peak_flops_int8"], "hbm_bw": v5e["hbm_bw"],
        "link_bw": v5e["ici_bw"], "hbm_per_chip": v5e["hbm_per_chip"]})
    rng = np.random.default_rng(0)
    for shape_name in SHAPE_NAMES:
        shape = SHAPE_BY_NAME[shape_name]
        jshape = next(s for s in JAX_SHAPES if s.name == shape_name)
        cfg, jcfg = _pair(arch)
        for chips, quantized in ((256, False), (512, True)):
            flops, nbytes, coll = (float(x) for x in rng.uniform(1e9, 1e15, 3))
            got = roofline.roofline_report(flops, nbytes, coll, chips, cfg,
                                           shape, quantized=quantized)
            want = jax_roofline.roofline_report(flops, nbytes, coll, chips,
                                                jcfg, jshape,
                                                quantized=quantized)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            for prop in ("dominant", "bound_time_s", "useful_flops_ratio",
                         "roofline_fraction"):
                assert getattr(got, prop) == getattr(want, prop), prop


def test_model_n_is_the_references_sixteen_unless_given():
    """``roofline_report``'s ``model_n`` (the analytic term's model axis)
    defaults to the reference's 16; a one-chip report passes 1."""
    cfg, shape = get_config("qwen2-0.5b"), SHAPE_BY_NAME["decode_32k"]
    a = roofline.roofline_report(1e12, 1e12, 0.0, 256, cfg, shape)
    b = roofline.roofline_report(1e12, 1e12, 0.0, 256, cfg, shape,
                                 model_n=16)
    assert a == b
    one = roofline.roofline_report(1e12, 1e12, 0.0, 1, cfg, shape,
                                   model_n=1)
    assert one.memory_analytic_s == roofline.analytic_hbm_bytes(
        cfg, shape, chips=1, model_n=1) / roofline.HW_H100["hbm_bw"]


def test_hw_h100_is_the_data_sheet():
    """One H100 SXM5's dense peaks and memory, and no figure of the TPU
    the reference was sized for."""
    hw = roofline.HW_H100
    assert hw == {"peak_flops_bf16": 989e12, "peak_flops_int8": 1979e12,
                  "peak_flops_f32": 67e12, "hbm_bw": 3.35e12,
                  "hbm_per_chip": 80e9, "link_bw": 50e9,
                  "nvlink_bw": 450e9}
    assert not set(hw.values()) & set(jax_roofline.HW_V5E.values()) - {50e9}


def test_chip_smoke_takes_its_peaks_from_hw_h100(monkeypatch):
    """``chip_smoke.py``'s ``bound_ms`` divides by ``HW_H100``'s peaks, read
    at the call: the script and the dry-run cannot drift."""
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parents[1]))
    import chip_smoke

    hw = roofline.HW_H100
    for rate in (chip_smoke.INT8_OPS_S, chip_smoke.BF16_OPS_S,
                 chip_smoke.F32_OPS_S):
        assert chip_smoke.hw_peak(rate) == hw[rate]
        # operations bound: a second of the rate's work
        assert chip_smoke.bound_ms(0, hw[rate], rate) == (1e3, "operations")
    assert chip_smoke.bound_ms(hw["hbm_bw"], 0, chip_smoke.F32_OPS_S) == (
        1e3, "bytes")
    assert chip_smoke.hw_peak(chip_smoke.HBM_BYTES_S) == hw["hbm_bw"]
    assert "jax" not in vars(chip_smoke)

"""Which pipelines of resources/pipelines/*.json the port can run: each
pipeline's `work` modules checked against the port's module registry."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PIPELINES = ROOT / "resources" / "pipelines"

# the CCSDS 131.0-B deep-space pipelines: turbo behind pm_demod / psk_demod,
# LDPC behind psk_demod / pm_demod
DEEP_SPACE = (
    ("Chandrayaan.json", "chandrayaan3_link_2k"),
    ("Chandrayaan.json", "chandrayaan3_link_8k"),
    ("Escapade.json", "escapade_x_link"),
    ("Hera.json", "hera_x_link"),
    ("Juice.json", "juice_x_link"),
    ("ORX.json", "orx_link"),
    ("Psyche.json", "psyche_hr"),
    ("TGO.json", "tgo_link"),
    ("GOES.json", "goes_raw_sounder_data"),
    ("Iris.json", "iris_dump"),
    ("Orion.json", "orion_link"),
    ("Peregrine.json", "peregrine_x_tlm"),
)

# the DVB pipelines: every module of each is ported, GOES-R GRB's and
# HimawariCast's data decoders included
DVB = (
    ("DVB-S2.json", "dvbs2", None),
    ("Work-In-Progress.json", "eumetcast_africa", None),
    ("GOES.json", "goes_grb", None),
    ("DVB_Test.json", "dvbs2_test", None),
    ("Himawari.json", "himawaricast", None),
)


# FengYun-3 AHRPT, the NOAA and METEOR HRPT family and Inmarsat: each one's
# decoder behind a demod the port already had
HRPT_INMARSAT = (
    ("FengYun-3.json", "fengyun3_ab_ahrpt", "fengyun_ahrpt_decoder"),
    ("FengYun-3.json", "fengyun3_c_ahrpt", "fengyun_ahrpt_decoder"),
    ("FengYun-3.json", "fengyun3_d_ahrpt", "fengyun_ahrpt_decoder"),
    ("NOAA.json", "noaa_hrpt", "noaa_hrpt_decoder"),
    ("NOAA.json", "noaa_gac", "noaa_gac_decoder"),
    ("NOAA.json", "noaa_dsb", "noaa_dsb_decoder"),
    ("Meteor-M.json", "meteor_hrpt", "meteor_hrpt_decoder"),
    ("Inmarsat.json", "inmarsat_std_c", "inmarsat_stdc_decoder"),
    ("Inmarsat.json", "inmarsat_aero_6", "inmarsat_aero_decoder"),
    ("Inmarsat.json", "inmarsat_aero_12", "inmarsat_aero_decoder"),
    ("Inmarsat.json", "inmarsat_aero_105", "inmarsat_aero_decoder"),
    ("Inmarsat.json", "inmarsat_aero_84", "inmarsat_aero_decoder"),
)


# JPSS HRD, GOES HRIT's products level and the host decoders: each one's
# decoder or products module behind a demod the port already had
HOST_DECODERS = (
    ("JPSS.json", "npp_hrd", "jpss_instruments"),
    ("JPSS.json", "jpss_hrd", "jpss_instruments"),
    ("GOES.json", "goes_hrit", "goes_lrit_data_decoder"),
    ("EOS.json", "aqua_db", "eos_instruments"),
    ("GOES.json", "goes_gvar", "goes_gvar_image_decoder"),
    ("GOES.json", "goesn_sd", "goes_sd_image_decoder"),
    ("GOES.json", "goes_mdl", "goes_mdl_decoder"),
    ("Orbcomm.json", "orbcomm_stx", "orbcomm_plotter"),
    ("Radiosonde.json", "radiosonde_m10", "radiosonde_m10_decoder"),
    ("DVB_Test.json", "dvbs2_test", "network_server"),
)

# the xRIT image decoders and GOES-R GRB's data decoder, on the port's own
# JPEG, wavelet and JPEG 2000 codecs: the last six pipelines
XRIT_PRODUCTS = (
    ("Elektro_Arktika.json", "elektro_lrit", "elektro_lrit_data_decoder"),
    ("Elektro_Arktika.json", "elektro_hrit", "elektro_lrit_data_decoder"),
    ("GK2A.json", "gk2a_lrit", "gk2a_lrit_data_decoder"),
    ("GK2A.json", "gk2a_hrit", "gk2a_lrit_data_decoder"),
    ("GOES.json", "goes_grb", "goes_grb_data_decoder"),
    ("Himawari.json", "himawaricast", "himawaricast_data_decoder"),
)


def _pipelines():
    """{(file, id): [module ids of its work levels]}."""
    out = {}
    for f in sorted(PIPELINES.glob("*.json")):
        for pid, p in json.loads(f.read_text()).items():
            if isinstance(p, dict) and "work" in p:
                out[(f.name, pid)] = [lvl["module"] for lvl in
                                      p["work"].values()
                                      if isinstance(lvl, dict)
                                      and "module" in lvl]
    return out


def _registry():
    from satdump_tpu_torch.pipeline.module import (module_registry,
                                                   register_all_modules)
    register_all_modules()
    return set(module_registry)


@pytest.mark.parametrize("fname,pipe_id", DEEP_SPACE)
def test_deep_space_pipeline_has_every_module(fname, pipe_id):
    mods = _pipelines()[(fname, pipe_id)]
    assert {"ccsds_turbo_decoder", "ccsds_ldpc_decoder"} & set(mods)
    assert set(mods) <= _registry(), mods


@pytest.mark.parametrize("fname,pipe_id,first_missing", DVB)
def test_dvb_pipeline_modules(fname, pipe_id, first_missing):
    mods = _pipelines()[(fname, pipe_id)]
    assert mods[0] == "dvbs2_demod"
    reg = _registry()
    missing = [m for m in mods if m not in reg]
    assert missing[:1] == ([first_missing] if first_missing else [])
    assert set(mods[: mods.index(first_missing)] if first_missing
               else mods) <= reg


@pytest.mark.parametrize("fname,pipe_id,decoder", HRPT_INMARSAT)
def test_hrpt_inmarsat_pipeline_has_every_module(fname, pipe_id, decoder):
    mods = _pipelines()[(fname, pipe_id)]
    assert decoder in mods
    assert set(mods) <= _registry(), mods


@pytest.mark.parametrize("fname,pipe_id,decoder", HOST_DECODERS)
def test_host_decoder_pipeline_has_every_module(fname, pipe_id, decoder):
    mods = _pipelines()[(fname, pipe_id)]
    assert decoder in mods
    assert set(mods) <= _registry(), mods


@pytest.mark.parametrize("fname,pipe_id,decoder", XRIT_PRODUCTS)
def test_xrit_products_pipeline_has_every_module(fname, pipe_id, decoder):
    mods = _pipelines()[(fname, pipe_id)]
    assert decoder in mods
    assert set(mods) <= _registry(), mods


def test_pipelines_with_every_module_registered():
    pipes, reg = _pipelines(), _registry()
    full = [k for k, mods in pipes.items() if set(mods) <= reg]
    assert len(pipes) == 123
    assert len(full) >= 123, len(full)

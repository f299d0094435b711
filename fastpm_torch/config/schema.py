"""Parameter schema (reference: src/lua-runtime-fastpm.lua:14-346).

Declares every parameter with type/default/required/choices and the
derived-parameter actions (aout from output_redshifts, requirement
escalation, consistency checks). Enum values keep the lua-facing
spellings; force_mode 'zola' maps to 'fastpm' like the reference's
choices table does.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Any, Dict, List, Optional

__all__ = ["SCHEMA", "SchemaError", "validate"]


class SchemaError(Exception):
    pass


@dataclass
class Entry:
    name: str
    type: str
    default: Any = None
    required: bool = False
    choices: Optional[List[str]] = None


def E(name, type, default=None, required=False, choices=None):
    return Entry(name, type, default, required, choices)


SCHEMA: Dict[str, Entry] = {e.name: e for e in [
    E("nc", "int", required=True),
    E("boxsize", "number", required=True),
    E("time_step", "array:number", required=True),
    E("output_redshifts", "array:number"),
    E("aout", "array:number"),
    E("omega_m", "number"),
    E("Omega_m", "number"),
    E("T_cmb", "number", default=0.0),
    E("h", "number", default=0.7, required=True),
    E("Omega_k", "number", default=0.0),
    E("w0", "number", default=-1.0),
    E("wa", "number", default=0.0),
    E("N_eff", "number", default=3.046),
    E("N_nu", "number", default=0.0),
    E("m_ncdm", "array:number", default=[]),
    E("pm_nc_factor", "array:number", required=True),
    E("lpt_nc_factor", "number", default=1.0),
    E("np_alloc_factor", "number", required=True),
    # extension: emulate the reference's per-rank rand streams
    # (store.c:693-718) for golden-count reproduction of N-rank runs
    E("rand_ntask", "number", default=1),
    E("compute_potential", "boolean", default=False),
    E("compute_tidal", "boolean", default=False),
    E("n_shell", "number", default=10),
    E("lvk", "boolean", default=True),
    E("n_side", "number", default=3),
    E("every_ncdm", "number", default=4),
    E("ncdm_sphere_scheme", "enum", default="fibonacci",
      choices=["fibonacci", "healpix"]),
    E("ncdm_matterlike", "boolean", default=True),
    E("ncdm_freestreaming", "boolean", default=True),
    E("ncdm_linearresponse", "boolean", default=False),
    E("ncdm_transfer_redshift", "number"),
    E("ncdm_transfer_nu_file", "file"),
    E("growth_mode", "enum", default="ODE", choices=["LCDM", "ODE"]),
    E("painter_type", "enum", default="cic",
      choices=["cic", "linear", "lanczos", "quad"]),
    E("painter_support", "int", default=2),
    E("force_mode", "enum", default="fastpm",
      choices=["cola", "zola", "fastpm", "pm"]),
    E("enforce_broadband_kmax", "int", default=4),
    E("f_nl_type", "enum", default="none", choices=["local", "none"]),
    E("f_nl", "number"),
    E("kmax_primordial_over_knyquist", "number", default=0.666),
    E("scalar_amp", "number"),
    E("scalar_pivot", "number"),
    E("scalar_spectral_index", "number"),
    E("read_lineark", "string"),
    E("read_powerspectrum", "file"),
    E("read_linear_growth_rate", "file"),
    E("linear_density_redshift", "number", default=0.0),
    E("read_lineark_ncdm", "string"),
    E("read_powerspectrum_ncdm", "file"),
    E("read_linear_growth_rate_ncdm", "file"),
    E("linear_density_redshift_ncdm", "number", default=0.0),
    E("read_grafic", "string"),
    E("read_runpbic", "string"),
    E("read_whitenoisek", "string"),
    E("sigma8", "number", default=0.0),
    E("random_seed", "int"),
    E("shift", "boolean", default=False),
    E("inverted_ic", "boolean", default=False),
    E("remove_cosmic_variance", "boolean", default=False),
    E("write_linearr", "string"),
    E("write_lineark", "string"),
    E("write_whitenoisek", "string"),
    E("write_runpbic", "string"),
    E("write_powerspectrum", "string"),
    E("write_snapshot", "string"),
    E("write_nonlineark", "string"),
    E("write_runpb_snapshot", "string"),
    E("particle_fraction", "number", default=1.0),
    E("sort_snapshot", "boolean", default=True),
    E("write_fof", "string"),
    E("fof_linkinglength", "number", default=0.2),
    E("fof_nmin", "number", default=20),
    E("fof_kdtree_thresh", "number", default=8),
    E("write_rfof", "string"),
    E("rfof_kdtree_thresh", "number", default=8),
    E("rfof_linkinglength", "number", default=0.2),
    E("rfof_nmin", "number", default=8),
    E("rfof_l1", "number", default=0.25),
    E("rfof_l6", "number", default=0.24),
    E("rfof_a1", "number", default=0.012),
    E("rfof_a2", "number", default=0.06),
    E("rfof_b1", "number", default=7.02),
    E("rfof_b2", "number", default=6.025),
    E("lc_amin", "number", default=0.0),
    E("lc_amax", "number", default=1.0),
    E("lc_write_usmesh", "string"),
    E("lc_usmesh_nslices", "number", default=256),
    E("lc_usmesh_alloc_factor", "number", default=1.0),
    E("lc_usmesh_fof_padding", "number", default=10.0),
    E("lc_usmesh_ell_limit", "number", default=0),
    E("lc_usmesh_healpix_nside", "number", default=0),
    E("lc_usmesh_tiles", "array:number",
      default=[[0.0, 0.0, 0.0]]),
    E("dh_factor", "number", default=1.0),
    E("lc_fov", "number", default=0.0),
    E("lc_octants", "array:number", default=[0, 1, 2, 3, 4, 5, 6, 7]),
    E("lc_glmatrix", "array:number",
      default=[[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]),
    E("za", "boolean", default=False),
    E("kernel_type", "enum", default="1_4",
      choices=["1_4", "1_4_DIFF0", "3_4", "gadget", "5_4", "eastwood",
               "naive", "3_2"]),
    E("force_softening_type", "enum", default="none",
      choices=["none", "gaussian", "gadget_long_range", "gaussian36",
               "twothird"]),
    E("constraints", "array:number"),
    E("set_mode_method", "string", default="override"),
    E("set_mode", "array:number"),
    E("pgdc", "boolean", default=False),
    E("pgdc_alpha0", "number", default=0.8),
    E("pgdc_A", "number", default=4.0),
    E("pgdc_B", "number", default=8.0),
    E("pgdc_kl", "number", default=2.0),
    E("pgdc_ks", "number", default=10.0),
]}


def _check_type(entry: Entry, value):
    t = entry.type
    if value is None:
        return None
    if t == "int":
        if not isinstance(value, (int, float)):
            raise SchemaError(f"{entry.name}: expected int, got {value!r}")
        return int(value)
    if t == "number":
        if not isinstance(value, (int, float)):
            raise SchemaError(f"{entry.name}: expected number, got {value!r}")
        return float(value)
    if t == "boolean":
        if not isinstance(value, bool):
            raise SchemaError(f"{entry.name}: expected boolean, got {value!r}")
        return value
    if t in ("string", "file"):
        if not isinstance(value, str):
            raise SchemaError(f"{entry.name}: expected string, got {value!r}")
        return value
    if t == "enum":
        if value not in entry.choices:
            raise SchemaError(f"{entry.name}: invalid choice {value!r} "
                              f"(choices: {entry.choices})")
        return value
    if t == "array:number":
        if isinstance(value, (int, float)):
            return [float(value)]
        if isinstance(value, list):
            return value
        raise SchemaError(f"{entry.name}: expected array, got {value!r}")
    raise SchemaError(f"unknown schema type {t}")


def validate(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Validate and apply defaults + actions. Returns the full parameter
    namespace. Unknown globals are ignored (the reference's parser binds
    only declared names)."""
    ns: Dict[str, Any] = {}
    for name, entry in SCHEMA.items():
        val = raw.get(name, None)
        val = _check_type(entry, val)
        if val is None:
            val = entry.default
        ns[name] = val

    # ---- actions (lua-runtime-fastpm.lua:20-34, 77-130, ...) ----
    if raw.get("omega_m") is not None:
        raise SchemaError("omega_m is depreciated, please use Omega_m "
                          "(uppercase O) instead.")
    if ns["Omega_m"] is None:
        raise SchemaError("Omega_m is required")

    if ns["aout"] is None and ns["output_redshifts"] is not None:
        ns["aout"] = [1.0 / (z + 1.0) for z in ns["output_redshifts"]]
    if ns["aout"] is None:
        ns["aout"] = []

    ts = ns["time_step"]
    if ns["T_cmb"] != 0 and ns["growth_mode"] != "ODE":
        raise SchemaError("For a run with radiation (T_cmb > 0) use "
                          "growth_mode='ODE' for accurate results.")
    if ts and ts[0] < 0.00625 and ns["growth_mode"] == "ODE":
        raise SchemaError("Cannot start the simulation at a<0.00625 when "
                          "growth_mode=='ODE'.")

    m_ncdm = ns["m_ncdm"]
    if m_ncdm:
        for m in m_ncdm[1:]:
            if m > m_ncdm[0]:
                raise SchemaError("Please input the heaviest ncdm particle "
                                  "first.")
        if ns["ncdm_freestreaming"] and ns["n_shell"] != 0:
            raise SchemaError("For free-streaming ncdm use n_shell = 0 to "
                              "turn off ncdm particles.")
        if ns["ncdm_linearresponse"] and not ns["ncdm_freestreaming"]:
            raise SchemaError("For linear-response neutrino approach must "
                              "use free-streaming.")
        if (ns["ncdm_linearresponse"] and ns["ncdm_transfer_redshift"]
                is not None
                and abs(ts[0] - 1.0 / (1 + ns["ncdm_transfer_redshift"]))
                > 1e-12):
            raise SchemaError("Redshift of the neutrino transfer function "
                              "for lra should be at the starting redshift "
                              "of the simulation.")
        if not ns["ncdm_matterlike"] and ns["T_cmb"] == 0:
            raise SchemaError("For a run with exact Omega_ncdm, T_cmb > 0 "
                              "is required.")

    if ns["painter_type"] != "cic" and raw.get("painter_support") is None:
        raise SchemaError("painter_support is required for non-cic painters")

    if ns["f_nl_type"] != "none":
        for req in ("f_nl", "scalar_amp", "scalar_pivot",
                    "scalar_spectral_index"):
            if ns[req] is None:
                raise SchemaError(f"{req} is required when f_nl_type != none")

    if ns["read_grafic"] is None and ns["read_lineark"] is None \
            and ns["read_runpbic"] is None and ns["read_whitenoisek"] is None:
        pass  # seed path; random_seed checked by the IC driver

    for v in (ns["constraints"] or []):
        if not isinstance(v, list) or len(v) != 4:
            raise SchemaError("contraints must be a list of 4-vectors "
                              "(x, y, z, peak-sigma)")
    for v in (ns["set_mode"] or []):
        if not isinstance(v, list) or len(v) != 5:
            raise SchemaError("set_mode must be a list of 5-vectors")
        if v[3] not in (0, 1):
            raise SchemaError("the fourth component specifies real or imag "
                              "part of the mode. must be 0 or 1")

    # required check
    for name, entry in SCHEMA.items():
        if entry.required and ns[name] is None:
            raise SchemaError(f"parameter {name} is required")
    return ns

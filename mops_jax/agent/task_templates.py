"""Task config schemas + job-script rendering for the agent.

Re-design of the reference Agent/task_templates.py: default configs for the
three task families (remapping / streamline / pathline), NL parameter
extraction, standalone job-script rendering against the mops_jax API, and
auto-generation of stream YAML configs from a data folder
(reference Agent/task_templates.py:22-75 defaults,
generate_remapping_yaml_config:328)."""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

DEFAULT_REMAPPING_CONFIG = {
    "yaml_path": "stream.yaml",
    "device": None,             # None: the platform JAX reports
    "time_step": 0,
    "width": 3601,
    "height": 1801,
    "lat_range": [-90.0, 90.0],
    "lon_range": [-180.0, 180.0],
    "fixed_depth": 10.0,
    "add_temperature": True,
    "add_salinity": True,
    "output_subdir": "agent_outputs/remapping",
}

DEFAULT_STREAMLINE_CONFIG = {
    "yaml_path": "stream.yaml",
    "device": None,             # None: the platform JAX reports
    "duration_days": 5,
    "fixed_depth": 10.0,
    "lat_range": [35.0, 45.0],
    "lon_range": [-90.0, -65.0],
    "grid": [8, 8],
    "method": "rk4",
    "delta_minutes": 1,
    "record_every_minutes": 6,
    "output_subdir": "agent_outputs/streamline",
}

DEFAULT_PATHLINE_CONFIG = {
    "yaml_path": "stream.yaml",
    "device": None,             # None: the platform JAX reports
    "start_step": 0,
    "end_step": 1,
    "direction": "forward",
    "fixed_depth": 10.0,
    "lat_range": [35.0, 45.0],
    "lon_range": [-90.0, -65.0],
    "grid": [8, 8],
    "method": "rk4",
    "delta_minutes": 60,
    "record_every_minutes": 360,
    "output_subdir": "agent_outputs/pathline",
}


_NUM = r"[-+]?\d+(?:\.\d+)?"


def extract_config(task: str, request: str) -> Dict:
    """NL request -> config overrides on top of the task defaults.

    Regex extraction of common parameters (depth, dt, duration, resolution,
    seed grid, lat/lon boxes, method), mirroring the deterministic part of the
    reference agent's config extraction."""
    base = {"remapping": DEFAULT_REMAPPING_CONFIG,
            "streamline": DEFAULT_STREAMLINE_CONFIG,
            "pathline": DEFAULT_PATHLINE_CONFIG}[task]
    cfg = dict(base)
    text = request.lower()

    m = re.search(rf"depth\s*(?:of|at|=)?\s*({_NUM})\s*m", text)
    if m:
        cfg["fixed_depth"] = float(m.group(1))
    m = re.search(rf"({_NUM})\s*(?:-|\s)?day", text)
    if m and "duration_days" in cfg:
        cfg["duration_days"] = int(float(m.group(1)))
    m = re.search(r"(\d+)\s*[xX]\s*(\d+)", text)
    if m:
        a, b = int(m.group(1)), int(m.group(2))
        if task == "remapping":
            cfg["width"], cfg["height"] = a, b
        else:
            cfg["grid"] = [a, b]
    m = re.search(rf"dt\s*=?\s*({_NUM})\s*min", text)
    if m:
        cfg["delta_minutes"] = int(float(m.group(1)))
    if "euler" in text:
        cfg["method"] = "euler"
    if "backward" in text:
        cfg["direction"] = "backward"
    m = re.search(rf"lat\s*(?:range)?\s*[\[(]?\s*({_NUM})\s*[, ]\s*({_NUM})", text)
    if m:
        cfg["lat_range"] = [float(m.group(1)), float(m.group(2))]
    m = re.search(rf"lon\s*(?:range)?\s*[\[(]?\s*({_NUM})\s*[, ]\s*({_NUM})", text)
    if m:
        cfg["lon_range"] = [float(m.group(1)), float(m.group(2))]
    # named regions (reference agent defaults to the North Atlantic box)
    if "gulf of mexico" in text:
        cfg["lat_range"], cfg["lon_range"] = [18.0, 31.0], [-98.0, -80.0]
    if "north atlantic" in text:
        cfg["lat_range"], cfg["lon_range"] = [20.0, 50.0], [-80.0, -50.0]
    if "global" in text or "whole globe" in text:
        cfg["lat_range"], cfg["lon_range"] = [-90.0, 90.0], [-180.0, 180.0]
    return cfg


_JOB_HEADER = """\
#!/usr/bin/env python
# Auto-generated mops_jax job ({task})
import json
import os

import numpy as np
import mops_jax as mt
from mops_jax import api
from mops_jax.io import MPASOReader, StreamConfig, image as imgio

CONFIG = json.loads('''{config_json}''')

os.makedirs(CONFIG["output_subdir"], exist_ok=True)
app = api.MOPSApp()
app.init(CONFIG["device"])
app.begin()
reader = MPASOReader(StreamConfig.parse(CONFIG["yaml_path"]))
mesh = reader.read_mesh()
"""


def render_job(task: str, cfg: Dict) -> str:
    """Render a standalone runnable job script for the task."""
    header = _JOB_HEADER.format(task=task, config_json=json.dumps(cfg))
    if task == "remapping":
        body = """\
raw = reader.read_solution(CONFIG["time_step"])
raw.pop("_timestamp", None)
app.add_grid(mesh); app.add_solution(1, raw); app.end(); app.active_attribute(1)
vis = mt.VisualizationSettings(
    image_width=CONFIG["width"], image_height=CONFIG["height"],
    lat_range=tuple(CONFIG["lat_range"]), lon_range=tuple(CONFIG["lon_range"]),
    fixed_depth=CONFIG["fixed_depth"])
imgs = app.run_remapping(vis)
prefix = os.path.join(CONFIG["output_subdir"], "remap")
imgio.save_image_channels_png(prefix, imgs[0], ("east", "north", "speed"))
imgio.save_vti(prefix + ".vti", imgs, ["velocity", "attrs"][:len(imgs)])
print("remapping done ->", prefix)
"""
    elif task == "streamline":
        body = """\
raw = reader.read_solution(0)
raw.pop("_timestamp", None)
app.add_grid(mesh); app.add_solution(1, raw); app.end(); app.active_attribute(1)
seeds = app.generate_sample_points(mt.SamplingSettings(
    sample_range=tuple(CONFIG["grid"]), lat_range=tuple(CONFIG["lat_range"]),
    lon_range=tuple(CONFIG["lon_range"]), depth=CONFIG["fixed_depth"]))
cfg = mt.TrajectorySettings(
    delta_t=CONFIG["delta_minutes"] * 60,
    record_t=CONFIG["record_every_minutes"] * 60,
    simulation_duration=CONFIG["duration_days"] * mt.ONE_DAY,
    depth=CONFIG["fixed_depth"],
    method=mt.CalcMethod.RK4 if CONFIG["method"] == "rk4" else mt.CalcMethod.EULER,
    fail_mode=mt.FailMode.ZERO)
lines = app.run_streamline(cfg, seeds)
out = os.path.join(CONFIG["output_subdir"], "streamline.vtp")
imgio.save_trajectories_vtp(out, lines)
print("streamline done ->", out)
"""
    else:
        body = """\
for t in range(CONFIG["start_step"], CONFIG["end_step"] + 1):
    raw = reader.read_solution(t)
    raw.pop("_timestamp", None)
    app.add_solution(t, raw, timestep=t)
app.add_grid(mesh); app.end()
seeds = app.generate_sample_points(mt.SamplingSettings(
    sample_range=tuple(CONFIG["grid"]), lat_range=tuple(CONFIG["lat_range"]),
    lon_range=tuple(CONFIG["lon_range"]), depth=CONFIG["fixed_depth"]))
cfg = mt.TrajectorySettings(
    delta_t=CONFIG["delta_minutes"] * 60,
    record_t=CONFIG["record_every_minutes"] * 60,
    simulation_duration=mt.ONE_DAY,
    depth=CONFIG["fixed_depth"],
    direction=(mt.CalcDirection.FORWARD if CONFIG["direction"] == "forward"
               else mt.CalcDirection.BACKWARD),
    method=mt.CalcMethod.RK4 if CONFIG["method"] == "rk4" else mt.CalcMethod.EULER,
    fail_mode=mt.FailMode.ZERO)
all_lines = None
for t in range(CONFIG["start_step"], CONFIG["end_step"]):
    app.active_attribute(t, t + 1)
    lines = app.run_pathline(cfg, seeds)
    all_lines = lines if all_lines is None else all_lines
out = os.path.join(CONFIG["output_subdir"], "pathline.vtp")
imgio.save_trajectories_vtp(out, all_lines)
imgio.export_pathline_binary(out.replace(".vtp", ".bin"), all_lines)
print("pathline done ->", out)
"""
    return header + body


def generate_stream_yaml(data_dir: str, out_path: str,
                         mesh_pattern: Optional[str] = None,
                         data_pattern: Optional[str] = None) -> str:
    """Auto-generate a stream YAML from a folder of NetCDF files
    (reference Agent/task_templates.py generate_remapping_yaml_config:328):
    the largest file with mesh variables becomes the mesh substream; the rest
    become the data time series."""
    from ..io.netcdf import NetCDFFile

    files = sorted(f for f in os.listdir(data_dir) if f.endswith(".nc"))
    if not files:
        raise FileNotFoundError(f"no .nc files in {data_dir}")

    mesh_file = None
    if mesh_pattern:
        for f in files:
            if re.search(mesh_pattern, f):
                mesh_file = f
                break
    if mesh_file is None:
        for f in files:
            try:
                with NetCDFFile(os.path.join(data_dir, f)) as nc:
                    if nc.has("verticesOnCell") and nc.has("xCell"):
                        mesh_file = f
                        break
            except Exception:
                continue
    if mesh_file is None:
        raise ValueError("no file with MPAS mesh variables found")

    data_files = [f for f in files
                  if f != mesh_file and (data_pattern is None
                                         or re.search(data_pattern, f))]
    yaml_text = f"""stream:
  name: auto
  path_prefix: "{os.path.abspath(data_dir)}"
  substreams:
    - name: mesh
      format: netcdf
      filenames: "{mesh_file}"
      static: true
    - name: data
      format: netcdf
      filenames: {json.dumps(data_files if data_files else [mesh_file])}
      vars:
        - name: velocityZonal
          possible_names: [velocityZonal, timeMonthly_avg_velocityZonal]
        - name: velocityMeridional
          possible_names: [velocityMeridional, timeMonthly_avg_velocityMeridional]
        - name: layerThickness
          possible_names: [layerThickness, timeMonthly_avg_layerThickness]
        - name: temperature
          optional: true
        - name: salinity
          optional: true
"""
    with open(out_path, "w") as f:
        f.write(yaml_text)
    return out_path

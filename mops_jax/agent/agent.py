"""Natural-language task agent: request -> task family -> runnable job script.

Re-design of the reference Agent/llm_task_agent.py (routing :474-537, keyword
fallback :557): the router maps a request onto {remapping, streamline,
pathline}, extracts parameters, renders a standalone mops_jax job script, and
optionally executes it.  The LLM backend is a pluggable callable
(``llm=lambda system, user: json_str``) so any chat API can be attached; in
network-less environments the deterministic keyword router is used.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Tuple

from .task_templates import extract_config, render_job

SUPPORTED_TASKS = ("remapping", "streamline", "pathline")

_ROUTER_SYSTEM_PROMPT = """\
You are a strict task router for a scientific toolkit.
Map the user request onto exactly one task: remapping | streamline | pathline.
Return ONLY JSON: {"task": "...", "confidence": 0.0-1.0, "reason": "..."}.
Rules: remap/regrid/projection-to-image -> remapping; flow lines in one
snapshot -> streamline; time-evolving trajectories across snapshots -> pathline."""


@dataclasses.dataclass
class RouteResult:
    task: str
    confidence: float
    reason: str


def _keyword_route(request: str) -> RouteResult:
    """Deterministic fallback router (reference llm_task_agent.py:556-565)."""
    req = request.lower()
    if any(k in req for k in ("remap", "regrid", "raster", "mapping",
                              "projection", "image")):
        return RouteResult("remapping", 0.35, "keyword: remap/regrid")
    if any(k in req for k in ("pathline", "time-varying", "months",
                              "time-evolution", "evolve")):
        return RouteResult("pathline", 0.35, "keyword: pathline/time-varying")
    if any(k in req for k in ("stream", "snapshot", "steady")):
        return RouteResult("streamline", 0.35, "keyword: streamline")
    if any(k in req for k in ("trajector", "particle", "advect", "drift")):
        return RouteResult("pathline", 0.3, "keyword: trajectory")
    return RouteResult("pathline", 0.2, "default fallback")


def _extract_first_json(text: str) -> Optional[dict]:
    m = re.search(r"\{.*\}", text, re.DOTALL)
    if not m:
        return None
    try:
        return json.loads(m.group(0))
    except json.JSONDecodeError:
        return None


def route_request(request: str,
                  llm: Optional[Callable[[str, str], str]] = None) -> RouteResult:
    """Route a request; ``llm(system_prompt, user)`` may provide a model."""
    if llm is not None:
        try:
            parsed = _extract_first_json(llm(_ROUTER_SYSTEM_PROMPT, request))
            if parsed and parsed.get("task") in SUPPORTED_TASKS:
                conf = max(0.0, min(1.0, float(parsed.get("confidence", 0.0))))
                return RouteResult(parsed["task"], conf,
                                   str(parsed.get("reason", "llm")))
        except Exception:
            pass
    return _keyword_route(request)


def generate_job(request: str, output_dir: str = "agent_generated",
                 task: Optional[str] = None,
                 llm: Optional[Callable[[str, str], str]] = None,
                 overrides: Optional[Dict] = None) -> Tuple[str, str, Dict]:
    """Request -> (task, job script path, config)."""
    if task is None:
        task = route_request(request, llm).task
    cfg = extract_config(task, request)
    cfg.update(overrides or {})
    script = render_job(task, cfg)
    os.makedirs(output_dir, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    path = os.path.join(output_dir, f"job_{task}_{ts}.py")
    with open(path, "w") as f:
        f.write(script)
    with open(os.path.join(output_dir, f"config_{task}_{ts}.json"), "w") as f:
        json.dump(cfg, f, indent=2, sort_keys=True)
    return task, path, cfg


def run_agent(request: str, output_dir: str = "agent_generated",
              dry_run: bool = True, task: Optional[str] = None,
              llm: Optional[Callable[[str, str], str]] = None,
              overrides: Optional[Dict] = None) -> int:
    """End-to-end: route, render, optionally execute the generated job."""
    task, path, cfg = generate_job(request, output_dir, task, llm, overrides)
    print(f"[agent] task={task} script={path}")
    if dry_run:
        return 0
    return subprocess.run([sys.executable, path]).returncode

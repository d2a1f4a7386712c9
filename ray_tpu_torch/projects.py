"""Declarative projects (reference: python/ray/projects/ — `ray project`
yaml: name, cluster config, environment, named commands with params).

Load/validate a project yaml and resolve command templates; the CLI's
`session` subcommands would shell these out (kept library-level here).
"""

from __future__ import annotations

import os
import re
import shlex
from typing import Any, Dict, List, Optional

# The user's file keeps the JAX package's name: it is the project's format.
PROJECT_FILE = "ray-tpu-project.yaml"

_REQUIRED = ("name",)
_KNOWN_TOP = {"name", "description", "cluster", "environment", "commands"}


class ProjectError(ValueError):
    pass


def load_project(path: str) -> Dict[str, Any]:
    """Load + validate a project definition (dir or yaml file)."""
    if os.path.isdir(path):
        path = os.path.join(path, PROJECT_FILE)
    try:  # imported here: importing the package never loads pyyaml
        import yaml
    except ImportError:
        raise ProjectError("pyyaml unavailable") from None
    with open(path) as f:
        project = yaml.safe_load(f) or {}
    validate_project(project)
    return project


def validate_project(project: Dict[str, Any]) -> None:
    for key in _REQUIRED:
        if key not in project:
            raise ProjectError(f"project missing required key {key!r}")
    unknown = set(project) - _KNOWN_TOP
    if unknown:
        raise ProjectError(f"unknown project keys: {sorted(unknown)}")
    for cmd in project.get("commands", []):
        if "name" not in cmd or "command" not in cmd:
            raise ProjectError(
                f"command entries need name+command: {cmd!r}")
        for p in cmd.get("params", []):
            if "name" not in p:
                raise ProjectError(f"param needs a name: {p!r}")


def _command_entry(project: Dict[str, Any], name: str) -> Dict[str, Any]:
    for cmd in project.get("commands", []):
        if cmd["name"] == name:
            return cmd
    raise ProjectError(f"no command {name!r} in project {project['name']!r}")


def resolve_command(project: Dict[str, Any], name: str,
                    args: Optional[Dict[str, Any]] = None) -> List[str]:
    """Substitute {{param}} placeholders and return the argv."""
    cmd = _command_entry(project, name)
    args = dict(args or {})
    params = {p["name"]: p for p in cmd.get("params", [])}
    for pname, p in params.items():
        if pname not in args:
            if "default" in p:
                args[pname] = p["default"]
            else:
                raise ProjectError(f"missing required param {pname!r}")
        choices = p.get("choices")
        if choices and args[pname] not in choices:
            raise ProjectError(
                f"param {pname!r}={args[pname]!r} not in {choices}")
    extra = set(args) - set(params)
    if extra:
        raise ProjectError(f"unknown params: {sorted(extra)}")

    def sub(match):
        return str(args[match.group(1)])

    line = re.sub(r"\{\{\s*(\w+)\s*\}\}", sub, cmd["command"])
    return shlex.split(line)

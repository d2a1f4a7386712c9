"""wire-discipline: static cross-check of the binary wire codec.

``cluster/wire.py`` keeps growing (the version constant lives there, not
here — this checker reads it from the AST); every frame added carries
four obligations that nothing enforced until now:

  1. a frame id that collides with no other id (codes are append-only);
  2. a paired encoder + decoder, and the decoder registered in
     ``_DECODERS``;
  3. a version gate with a pickle fallback when the frame is newer than
     wire v1 — the ``peer_wire < N`` / ``return None`` dance that keeps
     rolling upgrades possible (``FRAME_MIN_WIRE`` is the declarative
     manifest this checker audits against, and its max must equal
     ``WIRE_VERSION`` so adding a frame without bumping the version is a
     lint error);
  4. a round-trip case in ``tests/test_wire_codec.py`` (the static twin
     of its dynamic frame coverage test; the port's codec twin,
     ``tests/test_torch_wire_codec.py``, runs that file's cases against
     the port) and a live handler/dispatch site in the cluster sources
     — a frame nobody handles is dead wire surface. The coverage check
     parses the test module's ``_FRAME_CASES`` keys (``wire.<FRAME>``
     attributes), so a frame merely *mentioned* in a comment or docstring
     no longer satisfies it.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..model import Checker, Finding, Module, Project

WIRE_PATH = "ray_tpu_torch/cluster/wire.py"
CODEC_TEST_PATH = "tests/test_wire_codec.py"
CLUSTER_PREFIX = "ray_tpu_torch/cluster/"

# Module-level ALL_CAPS int assignments that are NOT frame codes.
NON_FRAME_CONSTANTS = {"MAGIC", "WIRE_VERSION"}
NON_FRAME_PREFIXES = ("_", "MAX_", "SPEC_")

# Message types delivered by client-side push dispatch (RpcClient
# push_handler) rather than a server ``.handler(...)`` registration.
_ENC_PREFIX = "_enc_"
_DEC_PREFIX = "_dec_"


def _int_value(node: ast.expr) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def _module_dict(tree: ast.Module, name: str) -> Optional[ast.Dict]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name \
                and isinstance(node.value, ast.Dict):
            return node.value
    return None


class WireDisciplineChecker(Checker):
    rule_id = "wire-discipline"
    description = ("wire.py frame ids, encoder/decoder pairing, version "
                   "gates + pickle fallbacks, handler sites, codec tests")

    def run(self, project: Project) -> Iterator[Finding]:
        mod = project.get(WIRE_PATH)
        if mod is None:
            return
        tree = mod.tree

        frame_codes: Dict[str, int] = {}
        frame_lines: Dict[str, int] = {}
        wire_version: Optional[int] = None
        for node in tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            val = _int_value(node.value)
            if val is None:
                continue
            if name == "WIRE_VERSION":
                wire_version = val
                continue
            if not name.isupper() or name in NON_FRAME_CONSTANTS \
                    or name.startswith(NON_FRAME_PREFIXES):
                continue
            frame_codes[name] = val
            frame_lines[name] = node.lineno

        # ---- 1. id collisions ------------------------------------------
        by_value: Dict[int, List[str]] = {}
        for name, val in frame_codes.items():
            by_value.setdefault(val, []).append(name)
        for val, names in sorted(by_value.items()):
            if len(names) > 1:
                yield Finding(
                    rule=self.rule_id, path=mod.relpath,
                    line=frame_lines[names[1]], col=0,
                    message=(f"frame id collision: {', '.join(sorted(names))}"
                             f" all use code 0x{val:02X}"),
                    hint="codes are append-only; assign the next free code",
                    symbol=names[1])

        # ---- 2. decoder registration + encoder/decoder pairing ---------
        decoders = _module_dict(tree, "_DECODERS")
        decoder_keys: Set[str] = set()
        decoder_fns: Set[str] = set()
        if decoders is None:
            yield Finding(rule=self.rule_id, path=mod.relpath, line=1, col=0,
                          message="no module-level _DECODERS dict found",
                          hint="register every frame's decoder in _DECODERS",
                          symbol="_DECODERS")
        else:
            seen_keys: Set[str] = set()
            for key, val in zip(decoders.keys, decoders.values):
                kname = key.id if isinstance(key, ast.Name) else None
                if kname is None:
                    continue
                if kname in seen_keys:
                    yield Finding(
                        rule=self.rule_id, path=mod.relpath,
                        line=key.lineno, col=key.col_offset,
                        message=f"duplicate _DECODERS entry for {kname}",
                        hint="one decoder per frame code", symbol="_DECODERS")
                seen_keys.add(kname)
                decoder_keys.add(kname)
                if isinstance(val, ast.Name):
                    decoder_fns.add(val.id)
            for name in sorted(frame_codes):
                if name not in decoder_keys:
                    yield Finding(
                        rule=self.rule_id, path=mod.relpath,
                        line=frame_lines[name], col=0,
                        message=f"frame {name} has no _DECODERS entry",
                        hint="every frame id needs a registered decoder",
                        symbol=name)
            for kname in sorted(decoder_keys - set(frame_codes)):
                yield Finding(
                    rule=self.rule_id, path=mod.relpath,
                    line=decoders.lineno, col=0,
                    message=f"_DECODERS key {kname} is not a frame constant",
                    hint="declare the frame code at module level",
                    symbol="_DECODERS")

        fn_defs = {node.name: node for node in tree.body
                   if isinstance(node, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
        registered_encoders: Set[str] = set()
        encoder_types: Dict[str, str] = {}   # msg type -> encoder fn name
        resp_types: Dict[str, str] = {}
        for dict_name, sink in (("_ENCODERS", encoder_types),
                                ("_RESP_ENCODERS", resp_types)):
            table = _module_dict(tree, dict_name)
            if table is None:
                continue
            for key, val in zip(table.keys, table.values):
                if isinstance(key, ast.Constant) and isinstance(key.value, str) \
                        and isinstance(val, ast.Name):
                    sink[key.value] = val.id
                    registered_encoders.add(val.id)

        for enc_name in sorted(n for n in fn_defs if n.startswith(_ENC_PREFIX)):
            suffix = enc_name[len(_ENC_PREFIX):]
            dec_name = _DEC_PREFIX + suffix
            # Frame-level encoders emit a `_head(CODE, ...)` or sit in the
            # dispatch tables; item-level helpers (e.g. the "added"-list
            # sub-encoders) pair by name but never register a frame.
            is_frame_encoder = (enc_name in registered_encoders
                                or self._emitted_frames(fn_defs[enc_name]))
            if dec_name not in fn_defs:
                yield Finding(
                    rule=self.rule_id, path=mod.relpath,
                    line=fn_defs[enc_name].lineno, col=0,
                    message=f"encoder {enc_name} has no paired {dec_name}",
                    hint="every encoder needs a decoder twin (name-paired)",
                    symbol=enc_name)
            elif is_frame_encoder and dec_name not in decoder_fns \
                    and decoders is not None:
                yield Finding(
                    rule=self.rule_id, path=mod.relpath,
                    line=fn_defs[dec_name].lineno, col=0,
                    message=f"decoder {dec_name} is not registered in "
                            f"_DECODERS",
                    hint="add it to _DECODERS under its frame code",
                    symbol=dec_name)

        # ---- 3. FRAME_MIN_WIRE manifest + version gates ----------------
        manifest = _module_dict(tree, "FRAME_MIN_WIRE")
        min_wire: Dict[str, int] = {}
        if manifest is None:
            yield Finding(
                rule=self.rule_id, path=mod.relpath, line=1, col=0,
                message="no FRAME_MIN_WIRE manifest in wire.py",
                hint="declare {FRAME_CODE: min peer wire version} for every "
                     "frame so gates are auditable",
                symbol="FRAME_MIN_WIRE")
        else:
            for key, val in zip(manifest.keys, manifest.values):
                if isinstance(key, ast.Name) and _int_value(val) is not None:
                    min_wire[key.id] = _int_value(val)
            missing = sorted(set(frame_codes) - set(min_wire))
            for name in missing:
                yield Finding(
                    rule=self.rule_id, path=mod.relpath,
                    line=frame_lines[name], col=0,
                    message=f"frame {name} missing from FRAME_MIN_WIRE",
                    hint="declare the frame's minimum peer wire version",
                    symbol=name)
            for name in sorted(set(min_wire) - set(frame_codes)):
                yield Finding(
                    rule=self.rule_id, path=mod.relpath,
                    line=manifest.lineno, col=0,
                    message=f"FRAME_MIN_WIRE entry {name} is not a frame",
                    hint="remove the stale manifest entry", symbol=name)
            if min_wire and wire_version is not None \
                    and max(min_wire.values()) != wire_version:
                yield Finding(
                    rule=self.rule_id, path=mod.relpath, line=1, col=0,
                    message=(f"WIRE_VERSION is {wire_version} but the newest "
                             f"frame in FRAME_MIN_WIRE is v"
                             f"{max(min_wire.values())}"),
                    hint="bump WIRE_VERSION when adding a frame (and gate "
                         "its encoder on peer_wire)",
                    symbol="WIRE_VERSION")

        # Version-gated encoders: any encoder that can emit a >v1 frame
        # must compare peer_wire and have a `return None` pickle fallback.
        for enc_name, node in sorted(fn_defs.items()):
            if not enc_name.startswith(_ENC_PREFIX):
                continue
            emitted = self._emitted_frames(node)
            gated = [c for c in emitted if min_wire.get(c, 1) > 1]
            if not gated:
                continue
            has_gate = any(
                isinstance(n, ast.Compare) and any(
                    isinstance(x, ast.Name) and x.id == "peer_wire"
                    for x in ast.walk(n))
                for n in ast.walk(node))
            has_fallback = any(
                isinstance(n, ast.Return) and isinstance(n.value, ast.Constant)
                and n.value.value is None
                for n in ast.walk(node))
            if not (has_gate and has_fallback):
                yield Finding(
                    rule=self.rule_id, path=mod.relpath,
                    line=node.lineno, col=0,
                    message=(f"{enc_name} emits v>1 frame(s) "
                             f"{', '.join(sorted(gated))} without a "
                             f"peer_wire gate + `return None` pickle "
                             f"fallback"),
                    hint="check `peer_wire < N` and return None so pickle "
                         "carries the message to older peers",
                    symbol=enc_name)

        # ---- 4a. handler/dispatch sites --------------------------------
        handler_types: Set[str] = set()
        literal_strings: Set[str] = set()
        for other in project.glob(CLUSTER_PREFIX):
            if other.relpath == mod.relpath:
                continue
            for node in ast.walk(other.tree):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "handler" and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    handler_types.add(node.args[0].value)
                elif isinstance(node, ast.Constant) \
                        and isinstance(node.value, str):
                    literal_strings.add(node.value)
        if handler_types or literal_strings:
            for mtype, enc_name in sorted(encoder_types.items()):
                if mtype in resp_types and mtype not in handler_types:
                    yield Finding(
                        rule=self.rule_id, path=mod.relpath,
                        line=fn_defs[enc_name].lineno
                        if enc_name in fn_defs else 1, col=0,
                        message=(f"request type '{mtype}' has a response "
                                 f"codec but no .handler(...) site in the "
                                 f"cluster sources"),
                        hint="register a server handler or drop the codec",
                        symbol=enc_name)
                elif mtype not in handler_types \
                        and mtype not in literal_strings:
                    yield Finding(
                        rule=self.rule_id, path=mod.relpath,
                        line=fn_defs[enc_name].lineno
                        if enc_name in fn_defs else 1, col=0,
                        message=(f"message type '{mtype}' has a codec but "
                                 f"no handler or dispatch site in the "
                                 f"cluster sources"),
                        hint="dead wire surface: wire it up or remove it",
                        symbol=enc_name)

        # ---- 4b. codec-test coverage -----------------------------------
        test_mod = project.get(CODEC_TEST_PATH)
        if test_mod is not None:
            case_keys = self._frame_case_keys(test_mod.tree)
            if case_keys is None:
                # No enumerable _FRAME_CASES dict: fall back to the weaker
                # textual check so the rule degrades rather than vanishes.
                for name in sorted(frame_codes):
                    if name not in test_mod.source:
                        yield Finding(
                            rule=self.rule_id, path=mod.relpath,
                            line=frame_lines[name], col=0,
                            message=(f"frame {name} is never referenced in "
                                     f"{CODEC_TEST_PATH}"),
                            hint="add a round-trip + truncation case for it",
                            symbol=name)
            else:
                for name in sorted(set(frame_codes) - case_keys):
                    yield Finding(
                        rule=self.rule_id, path=mod.relpath,
                        line=frame_lines[name], col=0,
                        message=(f"frame {name} has no _FRAME_CASES entry "
                                 f"in {CODEC_TEST_PATH}"),
                        hint="add a wire.<FRAME> round-trip case to "
                             "_FRAME_CASES (textual mentions don't count)",
                        symbol=name)

    @staticmethod
    def _frame_case_keys(tree: ast.Module) -> Optional[Set[str]]:
        """Frame names enumerated as ``wire.<FRAME>`` keys of the test
        module's module-level ``_FRAME_CASES`` dict; None if the dict is
        absent (older layouts)."""
        table = _module_dict(tree, "_FRAME_CASES")
        if table is None:
            return None
        keys: Set[str] = set()
        for key in table.keys:
            if isinstance(key, ast.Attribute) \
                    and isinstance(key.value, ast.Name) \
                    and key.value.id == "wire":
                keys.add(key.attr)
        return keys

    @staticmethod
    def _emitted_frames(fn: ast.AST) -> Set[str]:
        """Frame constants passed to `_head(CODE, ...)` inside ``fn``."""
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id == "_head" and node.args:
                first = node.args[0]
                if isinstance(first, ast.Name):
                    out.add(first.id)
                elif isinstance(first, ast.IfExp):
                    for side in (first.body, first.orelse):
                        if isinstance(side, ast.Name):
                            out.add(side.id)
        return out

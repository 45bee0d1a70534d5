"""Parse model responses into action proposals.

Parity with the reference's ActionParser
(reference lib/quoracle/consensus/action_parser.ex:29-111,196-224): each
response must be a JSON object {action, params, reasoning, wait}; the parser
also lifts the optional per-response ``condense`` request (model asks to drop
its N oldest history entries — condensation.ex:38-48) and ``bug_report``
(models can file bug reports — utils/bug_report_logger.ex).

The PyTorch port's own copy of
``quoracle_tpu/consensus/parser.py``, line for line but for its
imports, so the parity tests can compare the two packages' outputs
field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from quoracle_tpu_torch.actions.schema import ACTIONS
from quoracle_tpu_torch.consensus.json_utils import extract_json


@dataclasses.dataclass
class ActionProposal:
    model_spec: str
    action: str
    params: dict
    reasoning: str = ""
    wait: Any = None                    # bool | int | None
    condense: Optional[int] = None
    bug_report: Optional[str] = None
    raw_text: str = ""


@dataclasses.dataclass
class ParseFailure:
    model_spec: str
    error: str
    raw_text: str = ""


def parse_response(model_spec: str, text: str) -> ActionProposal | ParseFailure:
    data = extract_json(text)
    if data is None:
        return ParseFailure(model_spec, "no JSON object found in response", text)
    if isinstance(data, list):
        data = next((d for d in data if isinstance(d, dict)), None)
        if data is None:
            return ParseFailure(model_spec, "JSON array contains no object", text)
    if not isinstance(data, dict):
        return ParseFailure(model_spec, "response JSON is not an object", text)

    action = data.get("action")
    if not isinstance(action, str) or not action:
        return ParseFailure(model_spec, "missing 'action' field", text)
    if action not in ACTIONS:
        return ParseFailure(model_spec, f"unknown action {action!r}", text)

    params = data.get("params", {})
    if params is None:
        params = {}
    if not isinstance(params, dict):
        return ParseFailure(model_spec, "'params' must be an object", text)

    condense = data.get("condense")
    if not (isinstance(condense, int) and not isinstance(condense, bool)
            and condense > 0):
        condense = None

    bug_report = data.get("bug_report")
    if not isinstance(bug_report, str) or not bug_report.strip():
        bug_report = None

    return ActionProposal(
        model_spec=model_spec,
        action=action,
        params=params,
        reasoning=str(data.get("reasoning", "")),
        wait=data.get("wait"),
        condense=condense,
        bug_report=bug_report,
        raw_text=text,
    )

"""NDH (CVDN dialog navigation) data adapter.

Counterpart of ``dasa_tpu/data/ndh.py``, a copy.

The reference's ndhtrain.py trains the same agent on CVDN dialogs:
`path_type` selects the supervision path (planner_path / player_path /
trusted_path, ndhtrain.py:374-434) and `history` selects how much dialog
context forms the instruction (none / target / oracle_ans /
nav_q_oracle_ans / all, ndhtrain.py:377, 436+).  This adapter converts
CVDN-format items into the R2R item schema so the whole
listener stack (env, agent, trainer, eval) runs unchanged.

CVDN item fields used: inst_idx, scan, target, start_pano{pano,heading},
dialog_history [{nav_idx, role, message}], planner_path, player_path,
nav_steps.
"""

from __future__ import annotations

from typing import Dict, List

PATH_TYPES = ("planner_path", "player_path", "trusted_path")
HISTORIES = ("none", "target", "oracle_ans", "nav_q_oracle_ans", "all")


def dialog_to_instruction(item: dict, history: str) -> str:
    """Assemble the instruction text from the dialog history."""
    target = item.get("target", "")
    if history == "none":
        return ""
    if history == "target":
        return f"<TAR> {target}"
    turns = item.get("dialog_history", [])
    parts: List[str] = []
    if history == "oracle_ans":
        for turn in turns:
            if turn.get("role") == "oracle":
                parts.append(f"<ORA> {turn['message']}")
        parts.append(f"<TAR> {target}")
    elif history == "nav_q_oracle_ans":
        for turn in turns:
            tag = "<NAV>" if turn.get("role") == "navigator" else "<ORA>"
            parts.append(f"{tag} {turn['message']}")
        parts.append(f"<TAR> {target}")
    elif history == "all":
        for turn in turns:
            tag = "<NAV>" if turn.get("role") == "navigator" else "<ORA>"
            parts.append(f"{tag} {turn['message']}")
        parts.append(f"<TAR> {target}")
    else:
        raise ValueError(history)
    return " ".join(parts)


def select_path(item: dict, path_type: str) -> List[str]:
    """trusted_path = planner path when the player found the goal,
    player path otherwise (the CVDN 'trusted' supervision mix)."""
    if path_type == "planner_path":
        return list(item["planner_path"])
    if path_type == "player_path":
        return list(item["player_path"])
    if path_type == "trusted_path":
        planner = list(item["planner_path"])
        player = list(item["player_path"])
        if player and planner and player[-1] == planner[-1]:
            return planner
        return player
    raise ValueError(path_type)


def convert_ndh_items(data: List[dict], path_type: str = "trusted_path",
                      history: str = "all") -> List[dict]:
    """CVDN items -> R2R-schema items consumable by R2REnv."""
    assert path_type in PATH_TYPES and history in HISTORIES
    out = []
    for item in data:
        path = select_path(item, path_type)
        if len(path) < 1:
            continue
        heading = item.get("start_pano", {}).get("heading", 0.0)
        out.append({
            "scan": item["scan"],
            "path_id": item.get("inst_idx", item.get("path_id")),
            "path": path,
            "heading": float(heading),
            "distance": 0.0,
            "instructions": [dialog_to_instruction(item, history)],
        })
    return out

"""Helpers for reading typed values out of JSON config dicts.

Reference behavior replicated: duplicate top-level JSON keys are a hard error
(reference: deepspeed/pt/deepspeed_config_utils.py:16) because a silently
shadowed key is almost always a user mistake in a hand-edited config.
"""

import json


def _reject_duplicate_keys(pairs):
    d = {}
    for key, value in pairs:
        if key in d:
            raise ValueError(f"Duplicate key '{key}' in DeepSpeed config JSON")
        d[key] = value
    return d


def load_config_json(path):
    """Load a JSON config file, rejecting duplicate keys at every nesting level."""
    with open(path, "r") as f:
        return json.load(f, object_pairs_hook=_reject_duplicate_keys)


def loads_config_json(text):
    return json.loads(text, object_pairs_hook=_reject_duplicate_keys)


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_dict_param(param_dict, param_name, param_default_value=None):
    value = param_dict.get(param_name, param_default_value)
    if value is None:
        return {}
    if not isinstance(value, dict):
        raise TypeError(
            f"Config key '{param_name}' expects an object, got {type(value).__name__}"
        )
    return value


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    # Kept under the reference's helper name for drop-in familiarity.
    return _reject_duplicate_keys(ordered_pairs)

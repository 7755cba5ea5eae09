"""A minimal, behavior-compatible reimplementation of `yacs.config.CfgNode`.

The reference framework's entire configuration surface is a yacs CfgNode tree
(reference configs/default.py:1-141) driven by YAML files plus dotted
CLI override lists (`merge_from_file`, `merge_from_list`, `freeze`,
`defrost`). yacs is not available in this environment, so this module
provides the subset of the yacs API the framework uses, with the same
semantics:

  * attribute-style access and assignment (``cfg.train.lr``),
  * schema enforcement: merging a key that does not exist in the defaults
    raises ``KeyError``; merging a value of a mismatched type raises
    ``ValueError`` (with the same int<->float and str coercion carve-outs
    yacs allows),
  * ``freeze()`` makes the whole tree immutable; ``defrost()`` re-enables
    mutation,
  * ``merge_from_file(path)`` merges a YAML mapping,
  * ``merge_from_list([k1, v1, k2, v2, ...])`` merges dotted-key overrides,
    parsing each value with ``literal_eval`` first (yacs' `_decode_cfg_value`).
"""

from __future__ import annotations

import copy
from ast import literal_eval

import yaml

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """dict subclass exposing attribute access and yacs merge semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else dict(init_dict)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                init_dict[k] = CfgNode(v)
        super().__init__(init_dict)
        self.__dict__[CfgNode.IMMUTABLE] = False

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(
                "Attempted to set {} to {}, but CfgNode is immutable".format(
                    name, value
                )
            )
        if not isinstance(value, _VALID_TYPES + (CfgNode, dict)):
            raise ValueError(
                "Invalid type {} for key {}".format(type(value), name)
            )
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        self[name] = value

    # -- mutability --------------------------------------------------------
    def is_frozen(self):
        return self.__dict__[CfgNode.IMMUTABLE]

    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def _set_immutable(self, is_immutable):
        self.__dict__[CfgNode.IMMUTABLE] = is_immutable
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(is_immutable)

    def __setitem__(self, key, value):
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(
                "Attempted to set {} to {}, but CfgNode is immutable".format(
                    key, value
                )
            )
        super().__setitem__(key, value)

    # -- cloning & merging --------------------------------------------------
    def clone(self):
        return copy.deepcopy(self)

    def merge_from_file(self, cfg_filename):
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        _merge_a_into_b(CfgNode(loaded), self, self, [])

    def merge_from_other_cfg(self, cfg_other):
        _merge_a_into_b(cfg_other, self, self, [])

    def merge_from_list(self, cfg_list):
        assert len(cfg_list) % 2 == 0, (
            "Override list has odd length: {}; it must be a list of pairs".format(
                cfg_list
            )
        )
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            key_list = full_key.split(".")
            d = self
            for subkey in key_list[:-1]:
                if subkey not in d:
                    raise KeyError("Non-existent key: {}".format(full_key))
                d = d[subkey]
            subkey = key_list[-1]
            if subkey not in d:
                raise KeyError("Non-existent key: {}".format(full_key))
            value = _decode_cfg_value(v)
            value = _check_and_coerce_cfg_value_type(value, d[subkey], subkey, full_key)
            d[subkey] = value

    def dump(self):
        def _to_plain(node):
            out = {}
            for k, v in node.items():
                out[k] = _to_plain(v) if isinstance(v, CfgNode) else v
            return out

        return yaml.safe_dump(_to_plain(self))

    def __str__(self):
        def _indent(s, num_spaces):
            lines = s.split("\n")
            first = lines.pop(0)
            lines = [(num_spaces * " ") + line for line in lines]
            return "\n".join([first] + lines)

        r = ""
        for k, v in sorted(self.items()):
            sep = "\n" if isinstance(v, CfgNode) else " "
            attr_str = "{}:{}{}".format(str(k), sep, str(v))
            r += _indent(attr_str, 2) + "\n"
        return r.rstrip("\n")

    def __repr__(self):
        return "{}({})".format(self.__class__.__name__, super().__repr__())

    def __deepcopy__(self, memo):
        new = CfgNode()
        memo[id(self)] = new
        for k, v in self.items():
            dict.__setitem__(new, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        new.__dict__[CfgNode.IMMUTABLE] = self.__dict__[CfgNode.IMMUTABLE]
        return new


def _merge_a_into_b(a, b, root, key_list):
    for k, v_ in a.items():
        full_key = ".".join(key_list + [str(k)])
        if k not in b:
            raise KeyError("Non-existent config key: {}".format(full_key))
        v = _decode_cfg_value(copy.deepcopy(v_))
        if isinstance(v, dict):
            v = CfgNode(v)
        if isinstance(v, CfgNode):
            _merge_a_into_b(v, b[k], root, key_list + [str(k)])
        else:
            v = _check_and_coerce_cfg_value_type(v, b[k], k, full_key)
            b[k] = v


def _decode_cfg_value(v):
    if isinstance(v, dict):
        return CfgNode(v)
    if not isinstance(v, str):
        return v
    try:
        return literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _check_and_coerce_cfg_value_type(replacement, original, key, full_key):
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type or original is None:
        return replacement
    # yacs carve-outs: int->float promotion, list<->tuple casting
    if isinstance(replacement, int) and isinstance(original, float):
        return float(replacement)
    if isinstance(replacement, tuple) and isinstance(original, list):
        return list(replacement)
    if isinstance(replacement, list) and isinstance(original, tuple):
        return tuple(replacement)
    raise ValueError(
        "Type mismatch ({} vs. {}) with values ({} vs. {}) for config key: {}".format(
            original_type, replacement_type, original, replacement, full_key
        )
    )


CN = CfgNode

"""repro_torch.query — declarative property-graph pattern engine.

Pattern text → AST (``parse``) → plan (``plan_pattern``) → execution
(``execute_plan``) over ``DIGraph`` + the DIP attribute stores.  The public
entry points on ``PropGraph`` are ``match()`` / ``explain()``.
"""
from repro_torch.query.ast import EdgePattern, NodePattern, Pattern, Predicate
from repro_torch.query.executor import MatchResult, execute_plan, execute_plan_with_masks
from repro_torch.query.parser import ParseError, parse
from repro_torch.query.plan import MaskStep, Plan, PredicateStep
from repro_torch.query.planner import plan_pattern
from repro_torch.query.weights import edge_weight_values

__all__ = [
    "Pattern",
    "NodePattern",
    "EdgePattern",
    "Predicate",
    "parse",
    "ParseError",
    "Plan",
    "MaskStep",
    "PredicateStep",
    "plan_pattern",
    "MatchResult",
    "execute_plan",
    "execute_plan_with_masks",
    "edge_weight_values",
]

"""The LM serving path (the port of ``repro.serve``): partial-hosting
plans, the plan-aware serving engine and the single-instance edge
scheduler."""

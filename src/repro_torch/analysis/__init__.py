"""Persist-order analysis for the port's host heap: the named
fault-injection sites of :mod:`.faults` (the reference's ``trace``,
``persist_lint`` and ``static_checks`` are not ported; ROADMAP A)."""

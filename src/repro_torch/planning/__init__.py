"""Planning (port of ``repro.planning``): so far only the KV-pool
pricing the paged engine sizes its pool with (``cost``); the planner,
plan grammar and cost model wait for the planning slice (ROADMAP)."""

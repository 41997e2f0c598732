"""The per-tenant admission plane the gserver manager enforces (the
HTTP/SSE gateway itself is not ported: ROADMAP.md queue 1, item 16)."""

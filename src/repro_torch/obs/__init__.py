"""Observability of the port: the fixed-bin fleet histograms in this slice
(``obs.hist``); event logs, metrics and reports wait for ``ROADMAP.md``
Queue 1 item 22."""

"""Reductions over the fleet's client axis.  One device in this slice; the
``torch.distributed`` forms wait for ``ROADMAP.md`` Queue 1 item 25."""

"""Requests a frontend dispatch carries on average
(``FrontendStats.events / dispatches``)."""


def read(view):
    c = view.counters
    if not c.get("frontend_dispatches"):
        return None
    return c["frontend_events"] / c["frontend_dispatches"]

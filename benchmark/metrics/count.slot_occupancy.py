"""Per cent of the window forwards' batch slots that held a window, over
the traced calls: windows over slots, from the engine's own plan
(``plan_batch_sets`` and ``chunk_plan``) of each call."""


def read(layer):
    if not layer.get("slots"):
        return None
    return 100.0 * layer["windows"] / layer["slots"]

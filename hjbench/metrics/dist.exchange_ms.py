"""The distributed tier's copies between and on the cards a call, in ms,
summed over the cell's cards and divided by them: the hot build rows'
gather (parallel/hotkeys.gather_hot_build_rows) and the build and probe
sides' ragged exchanges (parallel/mesh.Mesh.all_to_all), peer copies
over NVLink and device-to-device copies."""

PATTERNS = (r"^Memcpy PtoP", r"^Memcpy DtoD")


def read(t):
    return t.card_ms_per_join(PATTERNS)

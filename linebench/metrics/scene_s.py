"""Loading and preparing the scene: the host clock from creating the
renderer through loading the user's data to the scene representation the
mode draws from being built on the device, s. Moves setup_s."""

UNIT = "s"


def read(run):
    return run["scene_s"]

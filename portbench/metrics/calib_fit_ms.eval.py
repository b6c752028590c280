"""Mean host ms of the program's calib.fit span (VLCalibration.fit: the DAC fit) over the window's passes."""

from portbench import program


def read(reading):
    v = program.recent("calib.fit", len(reading.spans["calib_pass"]))
    return None if v is None else 1e3 * float(v.mean())

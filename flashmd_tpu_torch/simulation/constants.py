"""Physical constants and unit helpers
(reference: src/flashmd/simulation/base.py:35-38, utils.py:5-8)."""

import numpy as np

KBOLTZMANN = 1.38064852e-23  # Boltzmann's constant in Joules/Kelvin
AVOGADRO = 6.022140857e23  # Dimensionless Avogadro's number
JPERKCAL = 4184  # Ratio of Joules/kilocalorie


def calc_beta_from_temperature(temp):
    """Temperature(s) in Kelvin -> inverse temperature(s) in mol/kcal."""
    return JPERKCAL / KBOLTZMANN / AVOGADRO / np.array(temp)

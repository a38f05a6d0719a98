"""Contact-solver constants shared by the torch engine and the CUDA kernel.

Same values and meaning as ``mbd_tpu/sim/contact.py``: the impulse cap
bounds a contact's outgoing normal velocity to the Baumgarte pushout
min(β·φ/h, V_PUSH_MAX), and the projected Gauss–Seidel sweep over the
contact and joint-limit rows runs N_GS_PASSES times per substep.
"""

BAUMGARTE_BETA = 0.2
V_PUSH_MAX = 0.2     # m/s — max depenetration velocity a contact may add
N_GS_PASSES = 4

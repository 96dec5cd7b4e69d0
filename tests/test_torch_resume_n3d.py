"""tests/test_torch_resume.py's resume tests in densify mode 2 (Neural3D):
configs/neural_3D/flame_steak.json on tests/torch_n3d_scene.py's toy,
the checkpoint written by the port at 4,997 and resumed through both
packages' ``cli train`` to 5,003 (the refresh, SH step, pass, capacity
growth and reset at 5,000, the base-time z prune at 5,001, the CLI's
z < 4.5 prune of the loaded checkpoint), and flame_steak.json's whole
30,000-iteration schedule with the step stubbed."""
import pytest

from tests.test_torch_resume import (  # noqa: F401 (collected here)
    resume_both, test_full_schedule_matches_jax,
    test_resumed_best_psnr_is_seeded, test_resumed_capacity_is_padded,
    test_resumed_events_match_jax, test_resumed_losses_match_jax,
    test_resumed_sh_degree_restarts_at_zero,
    test_resumed_zprune_of_the_loaded_checkpoint)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    yield from resume_both("n3d", tmp_path_factory)

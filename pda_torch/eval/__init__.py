from .dice import (  # noqa: F401
    run_dice_evaluation,
    run_dice_evaluation_for_pseudo,
    run_em_dice_evaluation,
    run_lung_dice_evaluation,
)

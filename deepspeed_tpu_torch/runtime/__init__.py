"""The training runtime: engine, loss scaling, LR schedules."""

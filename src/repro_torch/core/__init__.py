# Core Flash-Cosmos model: bit algebra, expression IR, placement, planner,
# packed page store, reliability model and the execution engine.

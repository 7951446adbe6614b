"""The paper's experiment configurations as port configs."""

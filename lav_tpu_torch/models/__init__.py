"""LiDAR model, camera nets and UniPlanner inference."""
